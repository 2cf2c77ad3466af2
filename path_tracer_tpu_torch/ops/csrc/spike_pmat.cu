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
// two out: 18.9 MB at 524,288 rays, ~6 us at 3.35 TB/s) and executes ~38
// float ops per (ray, sphere) pair: 10.2 GFLOP at 524,288 rays x 512
// spheres, ~0.15 ms at the FP32 rate.  It is bound by operations.  The
// design:
//   * one thread per ray; the ray stays in registers for the whole fold,
//     each plane is read and written once, coalesced;
//   * the 512 x 9 table is staged once a block in shared memory, column
//     by column, so every thread of a warp reads the same word (a
//     broadcast) in the fold;
//   * the fold carries only (best key, best index); the winner's
//     attribute is one direct load afterwards, where the TPU gathered it
//     by a one-hot matrix product.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int P = 512;       // spheres
constexpr int NCOL = 9;      // c0x c0y c0z dcx dcy dcz t0 inv_dt r2
constexpr int META_ROW = 10; // the attribute row written to meta
constexpr int BLOCK = 256;

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

__global__ void __launch_bounds__(BLOCK) pmat_kernel(const PmatArgs A) {
  __shared__ float s_tab[NCOL][P];
  for (int i = threadIdx.x; i < P * NCOL; i += BLOCK) {
    s_tab[i % NCOL][i / NCOL] = __ldg(A.tab + i);
  }
  __syncthreads();
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= A.n_rays) return;

  const float ox = __ldg(A.ox + r), oy = __ldg(A.oy + r), oz = __ldg(A.oz + r);
  const float dx = __ldg(A.dx + r), dy = __ldg(A.dy + r), dz = __ldg(A.dz + r);
  const float tm = __ldg(A.tm + r);
  const float a = dx * dx + dy * dy + dz * dz;
  const float tmin_a = 1e-3f * a;

  float best = INFINITY;
  int bidx = 0;
  for (int p = 0; p < P; ++p) {
    const float kmov = (tm - s_tab[6][p]) * s_tab[7][p];
    const float cx = s_tab[0][p] + kmov * s_tab[3][p];
    const float cy = s_tab[1][p] + kmov * s_tab[4][p];
    const float cz = s_tab[2][p] + kmov * s_tab[5][p];
    const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
    const float b = ocx * dx + ocy * dy + ocz * dz;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - s_tab[8][p];
    const float disc = b * b - a * cc;
    const bool has = disc > 0.f;
    const float sq = __fsqrt_rn(has ? disc : 0.f);
    const float negb = -b;
    const float k1 = negb - sq;
    const float k2 = negb + sq;
    const bool ok1 = has && (k1 > tmin_a);
    const bool ok2 = has && (k2 > tmin_a);
    const float key = ok1 ? k1 : (ok2 ? k2 : INFINITY);
    if (key < best) {   // strict: the lowest index wins a tie
      best = key;
      bidx = p;
    }
  }
  A.t_out[r] = best;
  A.meta_out[r] = best < INFINITY ? __ldg(A.attrs + META_ROW * P + bidx)
                                  : 0.f;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int spike_pmat_launch(const float* tab, const float* attrs,
                                 const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const float* tm, float* t_out,
                                 float* meta_out, int n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const PmatArgs a{tab, attrs, ox, oy, oz, dx, dy, dz, tm, t_out, meta_out,
                   n_rays};
  const int grid = (n_rays + BLOCK - 1) / BLOCK;
  pmat_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* spike_pmat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
