// The nearest of P moving spheres for every ray, and one attribute of the
// winner, for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel tools/spike_pmat.py:run (the
// pallas_call of `kernel`).  Its plain PyTorch version, the executable
// spec, is path_tracer_tpu_torch/ops/spike_pmat.py:spike_pmat_plain.  Per
// ray: a = |d|^2; per sphere p, the centre at time tm, the c-o quadratic
// in t*|d|^2 key space, a hit where disc > 0, the first root if it is
// > 1e-3*a, else the second, else no key (inf).  The ray keeps the least
// key and the lowest index among keys equal to it; t is that key (inf on
// a miss) and meta is attrs[10][index] (0 on a miss).  Every float op is
// the spec's op in the spec's order; with -fmad=false (no contraction)
// and an IEEE sqrt the two agree bit for bit.
//
// What bounds it on the H100.  It moves 36 bytes a ray (seven planes in,
// two out: 18.9 MB at 524,288 rays, ~6 us at 3.35 TB/s).  Every (ray,
// sphere) pair needs the prefix of the quadratic: the centre at tm 8, c-o
// 3, b 5, cc 6, disc 3 and the test 1, 26 float ops, each its own
// instruction under -fmad=false.  The roots (an IEEE sqrt of ~10
// instructions, two roots, their tests and the keep) are needed only
// where disc > 0: 1.3% of the spike's pairs.  So the kernel is bound by
// instruction issue on the prefix: ~7.0 GFLOP at 524,288 rays, which the
// 67 TFLOP/s bound (an FMA counted as two ops) reads as ~0.105 ms; with
// one instruction an op, ~0.21 ms at 1.98 GHz is the floor.  The first
// CUDA version (one thread a ray) issued ~75 instructions a pair: nine
// shared loads, and the sqrt, both roots and both selects on every pair.
// The design:
//   * roots only where a discriminant is positive: the R prefixes of a
//     sphere are computed first (independent work for the scheduler),
//     then each ends in a branch on disc > 0, so a warp in which no lane
//     has a positive discriminant (~68% of (warp, sphere) pairs on the
//     spike's inputs) skips the sqrt, the roots, their tests and the
//     keep.  SASS (chip_smoke.py phase 2) holds one FSETP-and-branch a
//     ray slot and unrolled sphere, and the sqrt's slow path as a call
//     under a second branch inside it;
//   * R = 2 rays a thread: each sphere record is read once for two rays
//     (R = 1 and R = 4 were slower at every size: R = 4's 64 registers
//     allow 4 blocks an SM where 48 allow 5);
//   * the 512 x 9 table is staged once a block in shared memory as two
//     16-byte records and one word a sphere ((c0x, c0y, c0z, t0),
//     (dcx, dcy, dcz, inv_dt), r2): three shared loads a sphere, a
//     broadcast when the threads of a warp read the same sphere;
//   * K threads a ray (K = 1 ... 32, a template parameter), so that a
//     narrow call fills 132 SMs and a wide one has many small blocks (its
//     last wave a small share): thread `sub` of a ray takes spheres sub,
//     sub + K, ... (neighbouring threads read neighbouring records), and
//     the K partial (key, index) pairs are reduced by a shuffle butterfly
//     in lexicographic order: the least key, and on equal keys the lowest
//     index, which is the sequential fold's first strict minimum;
//   * the fold carries only (best key, best index) a ray; the winner's
//     attribute is one direct load afterwards, where the TPU gathered it
//     by a one-hot matrix product.
// Measured on the H100 and dropped, each slower in the same call: a
// warp vote before the branch; a persistent grid that stages the table
// once for several ray groups; the table in __constant__ memory; a warp
// queue that defers the roots of positive discriminants and computes
// them 32 at a time (bit-equal, but slower); 3 resident blocks of more
// registers.  Unrolling the sphere loop 1 or 4 times, or blocks of 128
// or 512 threads, were level within noise.
// `spike_pmat.split_for` picks K from the ray count, following
// chip_smoke.py's timing of every K at the reference tool's sizes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int P = 512;       // spheres
constexpr int NCOL = 9;      // c0x c0y c0z dcx dcy dcz t0 inv_dt r2
constexpr int META_ROW = 10; // the attribute row written to meta
constexpr int BLOCK = 256;
constexpr int R = 2;         // rays a thread
constexpr unsigned FULL = 0xffffffffu;

struct PmatArgs {
  const float* tab;     // (P, 9) row-major
  const float* attrs;   // (A, P) row-major
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* tm;
  float* t_out;
  float* meta_out;
  int n_rays;
};

// Thread `sub` of the ray group whose first ray is `base`: its share of
// the fold for each of the group's R rays (base + i * BLOCK / K), the
// lexicographic merge of the K shares, and the store.  A ray past n_rays
// folds the last ray and is not written; every thread runs to the merge,
// so that the shuffles see full warps.
template <int K>
__device__ __forceinline__ void fold_group(const PmatArgs& A,
                                          const float4* s_c,
                                          const float4* s_v,
                                          const float* s_r2, int base,
                                          int sub) {
  constexpr int GROUPS = BLOCK / K;
  float ox[R], oy[R], oz[R], dx[R], dy[R], dz[R], tm[R], a[R], tmin_a[R];
  float best[R];
  int bidx[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = min(base + i * GROUPS, A.n_rays - 1);
    ox[i] = __ldg(A.ox + r);
    oy[i] = __ldg(A.oy + r);
    oz[i] = __ldg(A.oz + r);
    dx[i] = __ldg(A.dx + r);
    dy[i] = __ldg(A.dy + r);
    dz[i] = __ldg(A.dz + r);
    tm[i] = __ldg(A.tm + r);
    a[i] = dx[i] * dx[i] + dy[i] * dy[i] + dz[i] * dz[i];
    tmin_a[i] = 1e-3f * a[i];
    best[i] = INFINITY;
    bidx[i] = 0;
  }

#pragma unroll 2
  for (int p = sub; p < P; p += K) {
    const float4 c = s_c[p];
    const float4 v = s_v[p];
    const float r2 = s_r2[p];
    float b[R], disc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {   // the R prefixes, independent work
      const float kmov = (tm[i] - c.w) * v.w;
      const float cx = c.x + kmov * v.x;
      const float cy = c.y + kmov * v.y;
      const float cz = c.z + kmov * v.z;
      const float ocx = ox[i] - cx, ocy = oy[i] - cy, ocz = oz[i] - cz;
      b[i] = ocx * dx[i] + ocy * dy[i] + ocz * dz[i];
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - r2;
      disc[i] = b[i] * b[i] - a[i] * cc;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (disc[i] > 0.f) {   // the spec's sqrt(where(has, disc, 0))
        const float sq = __fsqrt_rn(disc[i]);
        const float negb = -b[i];
        const float k1 = negb - sq;
        const float k2 = negb + sq;
        const float key = k1 > tmin_a[i] ? k1
                                         : (k2 > tmin_a[i] ? k2 : INFINITY);
        if (key < best[i]) {   // strict: the lowest index wins a tie
          best[i] = key;
          bidx[i] = p;
        }
      }
    }
  }

#pragma unroll
  for (int off = 1; off < K; off <<= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float ok = __shfl_xor_sync(FULL, best[i], off);
      const int oi = __shfl_xor_sync(FULL, bidx[i], off);
      if (ok < best[i] || (ok == best[i] && oi < bidx[i])) {
        best[i] = ok;
        bidx[i] = oi;
      }
    }
  }
  if (sub != 0) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = base + i * GROUPS;
    if (r < A.n_rays) {
      A.t_out[r] = best[i];
      A.meta_out[r] = best[i] < INFINITY
                          ? __ldg(A.attrs + META_ROW * P + bidx[i])
                          : 0.f;
    }
  }
}

// A block holds BLOCK / K ray groups of R rays: thread t is thread t % K
// of group t / K (consecutive threads read consecutive rays).
template <int K>
__global__ void __launch_bounds__(BLOCK, 4) pmat_kernel(const PmatArgs A) {
  __shared__ float4 s_c[P];    // c0x c0y c0z t0
  __shared__ float4 s_v[P];    // dcx dcy dcz inv_dt
  __shared__ float s_r2[P];
  for (int i = threadIdx.x; i < P; i += BLOCK) {
    const float* row = A.tab + i * NCOL;
    s_c[i] = make_float4(__ldg(row + 0), __ldg(row + 1), __ldg(row + 2),
                         __ldg(row + 6));
    s_v[i] = make_float4(__ldg(row + 3), __ldg(row + 4), __ldg(row + 5),
                         __ldg(row + 7));
    s_r2[i] = __ldg(row + 8);
  }
  __syncthreads();

  fold_group<K>(A, s_c, s_v, s_r2,
                   blockIdx.x * (BLOCK / K * R) + threadIdx.x / K,
                   threadIdx.x % K);
}

template <int K>
int launch(const PmatArgs& a, cudaStream_t stream) {
  constexpr int rays_a_block = BLOCK / K * R;
  const int grid = (a.n_rays + rays_a_block - 1) / rays_a_block;
  pmat_kernel<K><<<grid, BLOCK, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` with K = split (1, 2, 4, ..., 32) threads a ray;
// returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a K the kernel was not built for.
extern "C" int spike_pmat_launch(const float* tab, const float* attrs,
                                 const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const float* tm, float* t_out,
                                 float* meta_out, int n_rays, int split,
                                 void* stream) {
  if (n_rays <= 0) return 0;
  const PmatArgs a{tab, attrs, ox, oy, oz, dx, dy, dz, tm, t_out, meta_out,
                   n_rays};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (split) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 4: return launch<4>(a, s);
    case 8: return launch<8>(a, s);
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* spike_pmat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
