// The bounce megakernel for Hopper (sm_90a): one path segment for every
// lane of the work-queue driver.
//
// Replaces the JAX reference package's TPU kernel
// ops/pallas/wave_bounce.py:wave_bounce (the pallas_call
// of _wave_kernel, which inlines ops/pallas/bounce_core.py:advance and
// camera_ray_block).  Its plain PyTorch version, the executable spec, is
// path_tracer_tpu_torch/ops/bounce_core.py:wave_step; every float op below
// is the same op in the same order, so with -fmad=false (no contraction)
// and IEEE divide/sqrt the two agree bit for bit, sin/cos/log included
// (both evaluate those in double and round once).
//
// What bounds it on the H100.  Per launch it moves the lane state once
// (~240 bytes a lane in and out, ~118 MB at 483,328 lanes: ~35 us at
// 3.35 TB/s), but an advancing lane executes ~17 float ops for each
// static sphere and ~25 for each moving one in the sphere fold: ~9,900
// ops a lane on the final scene's 496 spheres, ~2.8 GFLOP for the 271,536
// advancing lanes of a full-width call, 0.04 ms at 67 TFLOP/s (a rate
// that counts an FMA as two ops; with -fmad=false each op is its own
// instruction, so ~50% of it is the ceiling).  It is bound by the fold's
// operations, and narrow calls (1,024-24,576 lanes) by latency.  The
// design:
//   * the fold reads a copy of its sphere columns as 16-byte records
//     (wave_bounce.fold_table: one record a static sphere, three a moving
//     one), staged in shared memory by one bulk asynchronous copy that
//     completes on an mbarrier, issued at a block's first tile with an
//     advancing lane: one broadcast 16-byte load per record;
//   * persistent blocks: at most SMs x resident blocks, each taking an
//     equal span of lanes and walking over it in tiles, so the table is
//     staged once per block and no block carries an extra whole tile;
//   * per tile, a ballot and a prefix count write the advancing lanes'
//     rays to a dense list in shared memory and the fold runs over that
//     list only, so dead and stalled lanes leave no idle threads in it;
//     a thread computes the quadratics of four spheres before it keeps
//     any of them, so it has several in flight;
//   * K threads fold one lane (K = 1..32, a template parameter the
//     wrapper picks from the lane count so that narrow calls fill the
//     card): each takes every K-th sphere of each media segment, and the
//     K partial (key, index) pairs are reduced with warp shuffles in
//     lexicographic order, which is the sequential fold's strict first
//     minimum; the per-segment snapshots are the least partial keys;
//   * the per-lane rest (rect and triangle folds, merge, media, hit
//     record, textures, scatter, policy, regeneration) runs one thread a
//     lane; the winner's attributes come from one direct load of the
//     sphere table; a lane runs only its own material's scatter branch
//     (the draw masks are mutually exclusive, so draw counts are kept);
//   * K = 1 runs 4 blocks an SM at 64 registers and reads a lane's inputs
//     after the fold; K > 1 runs 3 at 80 and reads them in one round at
//     the start of the tile, which is what a latency-bound call needs;
//   * the TPU layout workarounds (2-carry fold with lane-gather
//     reconstruction, 16-way texture sweep, unrolled scans) are dropped;
//     the win record, draw counts and per-segment snapshots are kept;
//   * the media count is a template parameter for 1..4 media, so their
//     loops unroll and a lane's per-medium snapshots stay in registers.
//     NMED = 0 instantiates the kernel for a count read at run time
//     (5..MAX_MED): its media loops run to A.n_med over MAX_MED slots a
//     lane (ptxas keeps them in registers: no stack frame), and a tile's
//     sphere snapshots sit in dynamic shared memory behind the fold table;
//   * NMED = NMED_GLOBAL, taken only for a scene past either cap (more
//     than MAX_MED media, or a fold table over the wrapper's
//     MAX_FOLD_BYTES), is the correctness variant: K = 1, the fold reads
//     the table from global memory in the same record order with no
//     staging, and a lane's per-medium snapshots (sphere, rect, triangle)
//     live in a global scratch plane of 3 x n_med floats a lane that the
//     wrapper allocates per call.  Fold order, merge and every float
//     association are the other variants', so it too is bit-equal to the
//     plain version.
// Outputs go to separate buffers the wrapper allocates; nothing is updated
// in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32 planes read and written, in wave_bounce.F_RW order
enum { OX, OY, OZ, DX, DY, DZ, TM, TPX, TPY, TPZ, RADX, RADY, RADZ, ACCX,
       ACCY, ACCZ, ALIVE, S, BNC, WRK, N_RW };
// read-only float32 planes follow them in f_in (wave_bounce.F_RO)
enum { PIX = N_RW, SEND, STRD, N_IN };
enum { FK, FIDX, FWX, FWY, FWZ, N_FIX };

}  // namespace

// kernel arguments; mirrored by wave_bounce._Args (ctypes)
struct WaveArgs {
  const float* sph;        // (15, p_sph)
  const int* sph_segs;     // (n_med + 1, 2)
  const float* rect;       // (15, p_rect)
  const int* rect_segs;    // (n_med + 1)
  const float* tri;        // (17, p_tri)
  const int* tri_segs;     // (n_med + 1)
  const float* med;        // (17, n_med)
  const float* spec;       // (11, 16)
  const float* cam;        // (23)
  const float* f_in[N_IN];
  const long long* rng_in;
  const float* fix_in[N_FIX];
  const int* texel;
  const float* srv;
  float* f_out[N_RW];
  long long* rng_out;
  float* fix_out[N_FIX];
  float* win;
  float* t_hit;
  int n_lanes, p_sph, p_rect, p_tri, n_med, max_depth, attenuate;
  unsigned int seed;
  float t_min;
  const float4* fold;      // (fold_recs, 4): wave_bounce.fold_table
  int fold_recs;
  int split;               // K, threads a lane's sphere fold is split across
  int global;              // 1: the NMED_GLOBAL variant (wave_bounce.k1_variant)
  float* scratch;          // NMED_GLOBAL: (3, n_med, n_lanes) snapshot planes
};

namespace {

constexpr float INF = __builtin_huge_valf();
constexpr float BIG = 3.0e38f;
// float32 roundings of the reference's double constants (no double
// rounding through a decimal float literal)
constexpr float PI_F = (float)3.1415926535897932385;
constexpr float TWO_PI_F = (float)(2.0 * 3.1415926535897932385);
constexpr float HALF_PI_F = (float)(3.1415926535897932385 / 2.0);
constexpr float INV_2PI_F = (float)(1.0 / (2.0 * 3.1415926535897932385));
constexpr float INV_PI_F = (float)(1.0 / 3.1415926535897932385);
constexpr float INV255_F = (float)(1.0 / 255.0);
constexpr float EPS4_F = (float)1e-4;
constexpr float EPS7_F = (float)1e-7;
constexpr unsigned int INITIAL_STATE = 2463534242u;

// The most media the run-time instantiation (NMED = 0) takes.  Shared
// memory sets it: a tile's sphere snapshots take 4 * BLOCK / K bytes a
// medium (1 KB at K = 1) beside the fold table (up to 192 KB, the
// wrapper's MAX_FOLD_BYTES) and ~11 KB of static buffers, and a block may
// have 227 KB; 23 media fit beside the largest table.
constexpr int MAX_MED = 23;

// The variant past both caps: any media count, any fold table.
constexpr int NMED_GLOBAL = -1;

// Media in the scene: the template's count, or A.n_med for NMED <= 0.
template <int NMED>
__device__ __forceinline__ int media(int n_med) {
  return NMED > 0 ? NMED : n_med;
}
// Per-lane media slots: one a medium, or MAX_MED for NMED = 0.
template <int NMED>
__host__ __device__ constexpr int med_slots() {
  return NMED > 0 ? NMED : MAX_MED;
}

// A lane's per-medium snapshots.  The templated and run-time variants keep
// them in a register array of med_slots<NMED>() floats; NMED_GLOBAL in a
// column of its scratch plane (plane 0 the sphere fold's, 1 the rect
// fold's, 2 the triangle fold's), medium m at p[m * stride].
struct GlobalSnaps {
  float* p;
  size_t stride;
  __device__ __forceinline__ float& operator[](int m) const {
    return p[m * stride];
  }
};
template <int NMED>
struct SnapStore {
  using type = float[med_slots<NMED>()];
  __device__ __forceinline__ static void bind(type&, const WaveArgs&, int,
                                              int) {}
};
template <>
struct SnapStore<NMED_GLOBAL> {
  using type = GlobalSnaps;
  __device__ __forceinline__ static void bind(type& s, const WaveArgs& A,
                                              int plane, int idx) {
    s.p = A.scratch + (size_t)plane * A.n_med * A.n_lanes + idx;
    s.stride = (size_t)A.n_lanes;
  }
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// torch.minimum / torch.maximum: NaN in, NaN out
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float fsin(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float fcos(float x) { return (float)cos((double)x); }
__device__ __forceinline__ float flog(float x) { return (float)log((double)x); }

// ---- RNG (xorshift.hpp:72-74), masked draws keep the reference's counts --
__device__ __forceinline__ unsigned int xs32(unsigned int s) {
  s ^= s >> 7;
  s ^= s << 1;
  s ^= s >> 9;
  return s;
}
__device__ __forceinline__ float u01(unsigned int u) {
  return __uint2float_rn(u) * 0x1p-32f;
}
__device__ __forceinline__ float draw(unsigned int& s, bool m) {
  const unsigned int s2 = xs32(s);
  if (m) s = s2;
  return u01(s2);
}
__device__ __forceinline__ float draw_range(unsigned int& s, bool m, float lo,
                                            float hi) {
  const float f = draw(s, m);
  return lo + (hi - lo) * f;
}
__device__ __forceinline__ unsigned int splitmix32(unsigned int x) {
  x += 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x21F0AAADu;
  x = (x ^ (x >> 15)) * 0x735A2D97u;
  return x ^ (x >> 15);
}

// ---- degree-17 odd minimax atan on [-1, 1], as written in the reference -
__device__ __forceinline__ float fast_atan(float t) {
  const float t2 = t * t;
  float p = (float)-9.2563e-4;
  p = p * t2 + (float)5.9624e-3;
  p = p * t2 + (float)-1.97338e-2;
  p = p * t2 + (float)4.30889e-2;
  p = p * t2 + (float)-7.5005e-2;
  p = p * t2 + (float)0.10571;
  p = p * t2 + (float)-0.14182;
  p = p * t2 + (float)0.19993;
  p = p * t2 + (float)-0.33332;
  p = p * t2 + (float)0.999999;
  return p * t;
}
__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = tmax(ax, ay), lo = tmin(ax, ay);
  const float t = lo / (hi == 0.f ? 1.f : hi);
  float a = fast_atan(t);
  a = ay > ax ? HALF_PI_F - a : a;
  a = x < 0.f ? PI_F - a : a;
  return y < 0.f ? -a : a;
}
__device__ __forceinline__ float fast_asin(float y) {
  return fast_atan2(y, sqrtf(tmax(1.f - y * y, 0.f)));
}

__device__ __forceinline__ float unpack_scan(float meta) {
  return meta - floorf(meta * (1.f / 1024.f)) * 1024.f;
}

// a winner candidate of the cross-class merge (render.hpp:37-49)
struct Win {
  float t, scan, meta, par, ar, ag, ab, nx, ny, nz, u, v, tie, cls;
};

__device__ __forceinline__ void merge(Win& w, const Win& c) {
  const bool tie = c.t == w.t;
  const bool b_later = c.scan > w.scan;
  const bool rule = (b_later && c.tie > 0.f) || (!b_later && w.tie <= 0.f);
  if (c.t < w.t || (tie && rule)) w = c;
}

// what one segment produces before the policy (bounce_core.Adv)
struct Adv {
  unsigned int rng;
  bool hit, miss, tk_image, did_scatter, stop_emit;
  float px, py, pz, alb_x, alb_y, alb_z, atlas_idx, att_x, att_y, att_z;
  float ndx, ndy, ndz, sky_x, sky_y, sky_z, wscan, wcls, t_hit;
};

// ---- the sphere fold in key = t*|d|^2 space (sphere.hpp:59-106) ---------
// The ray of one advancing lane as the fold reads it.
struct FoldRay {
  float ox, oy, oz, dx, dy, dz, tm, a, tmin_a;
};

// -b and the discriminant of sphere j, from its record(s) in the staged
// fold table: record j + base for a static sphere, records 3j + base ..
// 3j + base + 2 for a moving one (its center at the ray's time first).
template <bool MOVING>
__device__ __forceinline__ void quad(const float4* tab, int j, int base,
                                     const FoldRay& r, float& nb,
                                     float& disc) {
  float cx, cy, cz, r2;
  if (MOVING) {
    const float4 c = tab[3 * j + base];      // cx, cy, cz, r^2 at t0
    const float4 v = tab[3 * j + base + 1];  // vx, vy, vz, t0
    const float inv_dt = tab[3 * j + base + 2].x;
    const float kmov = (r.tm - v.w) * inv_dt;
    cx = c.x + kmov * v.x;
    cy = c.y + kmov * v.y;
    cz = c.z + kmov * v.z;
    r2 = c.w;
  } else {
    const float4 c = tab[j + base];          // cx, cy, cz, r^2
    cx = c.x;
    cy = c.y;
    cz = c.z;
    r2 = c.w;
  }
  const float cox = cx - r.ox;
  const float coy = cy - r.oy;
  const float coz = cz - r.oz;
  nb = cox * r.dx + coy * r.dy + coz * r.dz;  // = -b
  const float cc = cox * cox + coy * coy + coz * coz - r2;
  disc = nb * nb - r.a * cc;
}

// Sphere j replaces the running (key, index) only when strictly closer.
__device__ __forceinline__ void keep_nearer(float nb, float disc,
                                            float tmin_a, int j, float& bk,
                                            int& bidx) {
  if (disc > 0.f) {  // strict: a tangent misses
    const float sq = sqrtf(disc);
    const float k1 = nb - sq, k2 = nb + sq;
    const float cand = k1 > tmin_a ? k1 : k2;
    if (cand > tmin_a && cand < bk) {
      bk = cand;
      bidx = j;
    }
  }
}

// Spheres lo, lo+K, ... below hi in order.  The quadratics of a batch of
// spheres are independent and computed together, so one thread keeps
// several in flight; they are then kept in order.
constexpr int STATIC_BATCH = 4;
constexpr int MOVING_BATCH = 4;

template <int K, bool MOVING>
__device__ __forceinline__ void fold_run(const float4* tab, int lo, int hi,
                                         int base, const FoldRay& r,
                                         float& bk, int& bidx) {
  constexpr int B = MOVING ? MOVING_BATCH : STATIC_BATCH;
  int j = lo;
  for (; j + (B - 1) * K < hi; j += B * K) {
    float nb[B], disc[B];
#pragma unroll
    for (int u = 0; u < B; ++u)
      quad<MOVING>(tab, j + u * K, base, r, nb[u], disc[u]);
#pragma unroll
    for (int u = 0; u < B; ++u)
      keep_nearer(nb[u], disc[u], r.tmin_a, j + u * K, bk, bidx);
  }
  for (; j < hi; j += K) {
    float nb, disc;
    quad<MOVING>(tab, j, base, r, nb, disc);
    keep_nearer(nb, disc, r.tmin_a, j, bk, bidx);
  }
}

// One thread's share of one lane's fold: spheres start+sub, start+sub+K,
// ... of each media segment's static run and of its moving run, read from
// the staged fold table (one record a static sphere, three a moving one).
// snap[m] is the running key after segment m.  The caller starts the
// carry at (inf, 0).
template <int NMED, int K, class Snaps>
__device__ __forceinline__ void fold_share(
    const float4* tab, const int* segs, const int nm, int sub,
    const FoldRay& r, float& bk, int& bidx, Snaps& snap) {
  int start = 0, moved = 0;  // moving spheres before the segment
#pragma unroll
  for (int m = 0; m <= nm; ++m) {
    const int static_end = __ldg(&segs[2 * m]), end = __ldg(&segs[2 * m + 1]);
    fold_run<K, false>(tab, start + sub, static_end, 2 * moved, r, bk, bidx);
    fold_run<K, true>(tab, static_end + sub, end, 2 * (moved - static_end),
                      r, bk, bidx);
    moved += end - static_end;
    if (m < nm) snap[m] = bk;
    start = end;
  }
}

// Reduce the K partial folds of one lane (K adjacent threads of a warp;
// every thread of the warp takes part).  The least (key, index) pair wins
// in lexicographic order: that is the sequential fold's first strict
// minimum, and (inf, 0) without a hit, as an inf or NaN candidate never
// enters either.  Each snapshot is the least partial key, the prefix of
// the fold up to its segment.
template <int NMED, int K, class Snaps>
__device__ __forceinline__ void reduce_split(
    const int nm, float& bk, int& bidx, Snaps& snap) {
#pragma unroll
  for (int off = 1; off < K; off <<= 1) {
    const float ok = __shfl_xor_sync(0xffffffffu, bk, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (ok < bk || (ok == bk && oi < bidx)) {
      bk = ok;
      bidx = oi;
    }
#pragma unroll
    for (int m = 0; m < nm; ++m)
      snap[m] = fminf(snap[m], __shfl_xor_sync(0xffffffffu, snap[m], off));
  }
}

// One path segment for an advancing lane (bounce_core.advance), given its
// sphere fold's result: the best key and index and the per-segment keys.
// i is the lane (NMED_GLOBAL's rect and triangle snapshots are its column).
template <int NMED, class Snaps>
__device__ __forceinline__ void advance(const WaveArgs& A, const int i,
                                        float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float tm, unsigned int rng,
                                        const float bk, const int bidx,
                                        const Snaps& sph_snap, Adv& o) {
  const int nm = media<NMED>(A.n_med);
  const float tmin_ = A.t_min;
  const float a = dx * dx + dy * dy + dz * dz;
  const float a_safe = a == 0.f ? 1.f : a;
  const float inv_a = 1.f / a_safe;
  const int ps = A.p_sph;
  const float* sph = A.sph;
  const float s_t = bk * inv_a;

  // winner attributes: one direct indexed load (sphere 0 when no hit)
  const float kmov_w = (tm - ld(&sph[6 * ps + bidx])) * ld(&sph[7 * ps + bidx]);
  const float bcx = ld(&sph[0 * ps + bidx]) + kmov_w * ld(&sph[3 * ps + bidx]);
  const float bcy = ld(&sph[1 * ps + bidx]) + kmov_w * ld(&sph[4 * ps + bidx]);
  const float bcz = ld(&sph[2 * ps + bidx]) + kmov_w * ld(&sph[5 * ps + bidx]);
  const float brinv = ld(&sph[9 * ps + bidx]);
  const float bmeta = ld(&sph[10 * ps + bidx]);

  // ---- rect fold (t space, reject form; rectangle.hpp:16-130) -----------
  const float inv_dx = 1.f / dx, inv_dy = 1.f / dy, inv_dz = 1.f / dz;
  const int pr = A.p_rect;
  const float* R = A.rect;
  float rt = INF, ru = 0.f, rv = 0.f, rmeta = 0.f, rpar = 0.f, rar = 0.f,
        rag = 0.f, rab = 0.f, rxy = 0.f, rxz = 0.f;
  typename SnapStore<NMED>::type rect_snap;
  SnapStore<NMED>::bind(rect_snap, A, 1, i);
  int start = 0;
#pragma unroll
  for (int m = 0; m <= nm; ++m) {
    const int end = __ldg(&A.rect_segs[m]);
    for (int j = start; j < end; ++j) {
      const float isxy = ld(&R[0 * pr + j]), isxz = ld(&R[1 * pr + j]);
      const float isyz = ld(&R[2 * pr + j]), kk = ld(&R[3 * pr + j]);
      const float a0 = ld(&R[4 * pr + j]), a1 = ld(&R[5 * pr + j]);
      const float b0 = ld(&R[6 * pr + j]), b1 = ld(&R[7 * pr + j]);
      const float o_k = isyz * ox + isxz * oy + isxy * oz;
      const float d_k = isyz * dx + isxz * dy + isxy * dz;
      const float t = (kk - o_k) / d_k;  // a true divide; 0/0 rejects below
      const float ca = isxy + isxz;
      const float o_a = ca * ox + isyz * oy;
      const float d_a = ca * dx + isyz * dy;
      const float cb = isxz + isyz;
      const float o_b = isxy * oy + cb * oz;
      const float d_b = isxy * dy + cb * dz;
      const float av = o_a + t * d_a;
      const float bv = o_b + t * d_b;
      const bool in_b = !((av < a0) || (av > a1) || (bv < b0) || (bv > b1));
      if (!(t < tmin_) && !(t > rt) && in_b && fabsf(t) < BIG) {
        rt = t;
        ru = (av - a0) * ld(&R[8 * pr + j]);
        rv = (bv - b0) * ld(&R[9 * pr + j]);
        rmeta = ld(&R[10 * pr + j]);
        rpar = ld(&R[11 * pr + j]);
        rar = ld(&R[12 * pr + j]);
        rag = ld(&R[13 * pr + j]);
        rab = ld(&R[14 * pr + j]);
        rxy = isxy;
        rxz = isxz;
      }
    }
    if (m < nm) rect_snap[m] = rt;
    start = end;
  }

  // ---- triangle fold (Moller-Trumbore, triangle.hpp:58-100) -------------
  const int pt = A.p_tri;
  const float* Tb = A.tri;
  float tt = INF, tmeta = 0.f, tpar = 0.f, tnx = 0.f, tny = 0.f, tnz = 0.f,
        tar = 0.f, tag = 0.f, tab = 0.f;
  typename SnapStore<NMED>::type tri_snap;
  SnapStore<NMED>::bind(tri_snap, A, 2, i);
  start = 0;
#pragma unroll
  for (int m = 0; m <= nm; ++m) {
    const int end = __ldg(&A.tri_segs[m]);
    for (int j = start; j < end; ++j) {
      const float v0x = ld(&Tb[0 * pt + j]), v0y = ld(&Tb[1 * pt + j]),
                  v0z = ld(&Tb[2 * pt + j]);
      const float e1x = ld(&Tb[3 * pt + j]), e1y = ld(&Tb[4 * pt + j]),
                  e1z = ld(&Tb[5 * pt + j]);
      const float e2x = ld(&Tb[6 * pt + j]), e2y = ld(&Tb[7 * pt + j]),
                  e2z = ld(&Tb[8 * pt + j]);
      const float hx = dy * e2z - dz * e2y;
      const float hy = dz * e2x - dx * e2z;
      const float hz = dx * e2y - dy * e2x;
      const float aa = e1x * hx + e1y * hy + e1z * hz;
      const float a_abs = fabsf(aa);
      const bool a_pos = aa > 0.f;
      const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
      const float u = sx * hx + sy * hy + sz * hz;
      const bool u_ok = !((u > 0.f) ^ a_pos) && (fabsf(u) <= a_abs);
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = dx * qx + dy * qy + dz * qz;
      const bool v_ok = !((v > 0.f) ^ a_pos) && (fabsf(u + v) <= a_abs);
      const float t = (e2x * qx + e2y * qy + e2z * qz) / aa;
      if ((a_abs >= EPS7_F) && u_ok && v_ok && !(t < tmin_) && !(t > tt)) {
        tt = t;
        tmeta = ld(&Tb[12 * pt + j]);
        tpar = ld(&Tb[13 * pt + j]);
        tnx = ld(&Tb[9 * pt + j]);
        tny = ld(&Tb[10 * pt + j]);
        tnz = ld(&Tb[11 * pt + j]);
        tar = ld(&Tb[14 * pt + j]);
        tag = ld(&Tb[15 * pt + j]);
        tab = ld(&Tb[16 * pt + j]);
      }
    }
    if (m < nm) tri_snap[m] = tt;
    start = end;
  }

  // ---- cross-class merge -------------------------------------------------
  const float psx = ox + s_t * dx, psy = oy + s_t * dy, psz = oz + s_t * dz;
  Win w{s_t, unpack_scan(bmeta), bmeta, ld(&sph[11 * ps + bidx]),
        ld(&sph[12 * ps + bidx]), ld(&sph[13 * ps + bidx]),
        ld(&sph[14 * ps + bidx]), (psx - bcx) * brinv, (psy - bcy) * brinv,
        (psz - bcz) * brinv, 0.f, 0.f, 0.f, 0.f};
  merge(w, Win{rt, unpack_scan(rmeta), rmeta, rpar, rar, rag, rab,
               1.f - rxy - rxz, rxz, rxy, ru, rv, 1.f, 1.f});
  // triangle normal = cross(e1, e2), u = v = 0 (triangle.hpp:94-99)
  merge(w, Win{tt, unpack_scan(tmeta), tmeta, tpar, tar, tag, tab, tnx, tny,
               tnz, 0.f, 0.f, 1.f, 2.f});

  // ---- media (constant_medium.hpp:28-77) ---------------------------------
  float earlier = INF;
  const float ray_len = sqrtf(a);
  const float inv_len = ray_len * inv_a;
#pragma unroll
  for (int m = 0; m < nm; ++m) {
    const float* M = A.med + m;
#define MD(r) ld(&M[(r) * nm])
    const float mcx = MD(1), mcy = MD(2), mcz = MD(3), mr = MD(4);
    const float ocx = ox - mcx, ocy = oy - mcy, ocz = oz - mcz;
    const float b = ocx * dx + ocy * dy + ocz * dz;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - mr * mr;
    const float disc = b * b - a * cc;
    const bool has = disc > 0.f;
    const float sq = sqrtf(has ? disc : 0.f);
    const float st1 = (-b - sq) * inv_a;
    const float st2 = (-b + sq) * inv_a;
    const bool hit2_s = has && (st2 > st1 + EPS4_F);
    const float pmnx = MD(5), pmny = MD(6), pmnz = MD(7);
    const float pmxx = MD(8), pmxy = MD(9), pmxz = MD(10);
    float ts[6];
    {
      const float kk[6] = {pmxz, pmnz, pmxy, pmny, pmxx, pmnx};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        // sides: xy@zmax, xy@zmin, xz@ymax, xz@ymin, yz@xmax, yz@xmin
        const int ax = 2 - k / 2;  // plane axis: z, z, y, y, x, x
        const float o_k = ax == 2 ? oz : (ax == 1 ? oy : ox);
        const float id_k = ax == 2 ? inv_dz : (ax == 1 ? inv_dy : inv_dx);
        const float o_a = ax == 0 ? oy : ox, d_a = ax == 0 ? dy : dx;
        const float a0 = ax == 0 ? pmny : pmnx, a1 = ax == 0 ? pmxy : pmxx;
        const float o_b = ax == 2 ? oy : oz, d_b = ax == 2 ? dy : dz;
        const float b0 = ax == 2 ? pmny : pmnz, b1 = ax == 2 ? pmxy : pmxz;
        const float t = (kk[k] - o_k) * id_k;
        const float av = o_a + t * d_a;
        const float bv = o_b + t * d_b;
        const bool okb = !((av < a0) || (av > a1) || (bv < b0) || (bv > b1))
                         && (fabsf(t) < BIG);
        ts[k] = okb ? t : INF;
      }
    }
    float entry = ts[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) entry = tmin(entry, ts[k]);
    float exit_t = INF;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      exit_t = tmin(exit_t, ts[k] < entry + EPS4_F ? INF : ts[k]);
    const bool hit2_b = (entry < BIG) && (exit_t < BIG);

    const bool is_box = MD(0) == 1.f;
    const bool hit2 = (is_box ? hit2_b : hit2_s) && (MD(12) > 0.f);
    const float t_in = is_box ? entry : st1;
    const float t_out = is_box ? exit_t : st2;
    float pre = tmin(sph_snap[m] * inv_a, rect_snap[m]);
    pre = tmin(pre, tri_snap[m]);
    pre = tmin(pre, earlier);
    const float t1c = tmax(tmax(t_in, tmin_), 0.f);
    const float t2c = tmin(t_out, pre);
    const bool draw_mask = hit2 && !(t1c >= t2c);
    float uni = draw(rng, draw_mask);
    uni = draw_mask ? uni : 0.5f;
    const float dist_inside = (t2c - t1c) * ray_len;
    const float hit_distance = MD(11) * flog(uni);
    const bool accept = draw_mask && !(hit_distance > dist_inside);
    const float t_e = t1c + hit_distance * inv_len;
    const float mmeta = MD(13);
    merge(w, Win{accept ? t_e : INF, unpack_scan(mmeta), mmeta, 0.f, MD(14),
                 MD(15), MD(16), 1.f, 0.f, 0.f, 0.f, 0.f, 1.f, 3.f});
    earlier = accept ? tmin(earlier, t_e) : earlier;
#undef MD
  }

  // ---- hit record (hitable.hpp:8-24) -------------------------------------
  const bool hit = w.t < BIG;
  const float t_hit = hit ? w.t : 0.f;
  const float px = ox + t_hit * dx, py = oy + t_hit * dy, pz = oz + t_hit * dz;
  const bool front = (w.cls == 3.f) || ((dx * w.nx + dy * w.ny + dz * w.nz) < 0.f);
  const float nx = front ? w.nx : -w.nx;
  const float ny = front ? w.ny : -w.ny;
  const float nz = front ? w.nz : -w.nz;
  // sphere uv: mercator of the flipped normal (sphere.hpp:13-24)
  const float phi = fast_atan2(nz, (nx == 0.f && nz == 0.f) ? 1.f : nx);
  const float theta = fast_asin(tmin(tmax(ny, -1.f), 1.f));
  const float u_merc = 1.f - (phi + PI_F) * INV_2PI_F;
  const float v_merc = (theta + HALF_PI_F) * INV_PI_F;
  const float uu = w.cls == 0.f ? u_merc : w.u;
  const float vv = w.cls == 0.f ? v_merc : w.v;

  const float mtype = floorf(w.meta * (1.f / 65536.f));
  const float rem = w.meta - mtype * 65536.f;
  const float texkind = floorf(rem * (1.f / 16384.f));
  const float rem2 = rem - texkind * 16384.f;
  const int texref = (int)floorf(rem2 * (1.f / 1024.f));

  // ---- textures (texture.hpp): checker here, image -> atlas index --------
  const float* sp = A.spec + texref;
#define SP(r) ld(&sp[(r) * 16])
  const bool tk_checker = texkind == 1.f;
  const bool tk_image = texkind == 2.f;
  float alb_x = w.ar, alb_y = w.ag, alb_z = w.ab;
  if (tk_checker) {
    const bool odd = (fsin(10.f * px) * fsin(10.f * py) * fsin(10.f * pz)) < 0.f;
    alb_x = odd ? SP(1) : SP(4);
    alb_y = odd ? SP(2) : SP(5);
    alb_z = odd ? SP(3) : SP(6);
  }
  const float twf = SP(7), thf = SP(8), toff = SP(9), tfreq = SP(10);
#undef SP
  const float fu = fmodf(uu * tfreq, 1.f);
  const float fv = fmodf(vv * tfreq, 1.f);
  const float wm1 = tmax(twf - 1.f, 0.f);
  const float hm1 = tmax(thf - 1.f, 0.f);
  const float ti = tmin(tmax(floorf(fu * wm1), 0.f), wm1);
  const float tj = tmin(tmax(floorf((1.f - fv) * hm1), 0.f), hm1);
  o.atlas_idx = toff + tj * twf + ti;
  if (tk_image) alb_x = alb_y = alb_z = 1.f;

  // ---- scatter (material.hpp:11-131) -------------------------------------
  const float inv_len_d = 1.f / sqrtf(a_safe);
  const float udx = dx * inv_len_d, udy = dy * inv_len_d, udz = dz * inv_len_d;
  const bool is_lam = hit && mtype == 0.f;
  const bool is_metal = hit && mtype == 1.f;
  const bool is_diel = hit && mtype == 2.f;
  const bool is_light = hit && mtype == 3.f;
  const bool is_iso = hit && mtype == 4.f;
  const float ud_dot_n = udx * nx + udy * ny + udz * nz;
  float ndx = 0.f, ndy = 0.f, ndz = 0.f;
  bool metal_alive = false;
  if (is_lam) {  // n + unit_vec (3 draws, rtweekend.hpp:60-67)
    const float xl = draw_range(rng, true, -1.f, 1.f);
    const float maxy = sqrtf(tmax(1.f - xl * xl, 0.f));
    const float fy = draw(rng, true);
    const float yl = -maxy + 2.f * maxy * fy;
    const float absz = sqrtf(tmax(maxy * maxy - yl * yl, 0.f));
    const float fz = draw(rng, true);
    ndx = nx + xl;
    ndy = ny + yl;
    ndz = nz + (fz > 0.5f ? absz : -absz);
  } else if (is_metal || is_diel) {
    const float rfl_x = udx - 2.f * ud_dot_n * nx;
    const float rfl_y = udy - 2.f * ud_dot_n * ny;
    const float rfl_z = udz - 2.f * ud_dot_n * nz;
    if (is_metal) {  // reflect + fuzz * ball (3 draws, rtweekend.hpp:70-80)
      const float br = draw(rng, true);
      const float bth = draw_range(rng, true, 0.f, TWO_PI_F);
      const float bph = draw_range(rng, true, 0.f, PI_F);
      const float plan = br * fsin(bph);
      ndx = rfl_x + w.par * (plan * fcos(bth));
      ndy = rfl_y + w.par * (plan * fsin(bth));
      ndz = rfl_z + w.par * (br * fcos(bph));
      metal_alive = (ndx * nx + ndy * ny + ndz * nz) > 0.f;
    } else {  // dielectric (material.hpp:68-89)
      const float ior = w.par;
      const float ratio = front ? 1.f / ior : ior;
      const float cos_t = tmin(-ud_dot_n, 1.f);
      const float sin_t = sqrtf(tmax(1.f - cos_t * cos_t, 0.f));
      const bool cannot = ratio * sin_t > 1.f;
      float r0 = (1.f - ratio) / (1.f + ratio);
      r0 = r0 * r0;
      const float omc = 1.f - cos_t;
      const float omc2 = omc * omc;
      const float reflectance = r0 + (1.f - r0) * (omc2 * omc2 * omc);
      const bool diel_draw = !cannot;
      const float unid = draw(rng, diel_draw);
      if (cannot || (diel_draw && (reflectance > unid))) {
        ndx = rfl_x;
        ndy = rfl_y;
        ndz = rfl_z;
      } else {
        const float rp_x = (udx + cos_t * nx) * ratio;
        const float rp_y = (udy + cos_t * ny) * ratio;
        const float rp_z = (udz + cos_t * nz) * ratio;
        const float rpar_ =
            -sqrtf(fabsf(1.f - (rp_x * rp_x + rp_y * rp_y + rp_z * rp_z)));
        ndx = rp_x + rpar_ * nx;
        ndy = rp_y + rpar_ * ny;
        ndz = rp_z + rpar_ * nz;
      }
    }
  } else if (is_iso) {  // ball (3 draws, material.hpp:122)
    const float ir = draw(rng, true);
    const float ith = draw_range(rng, true, 0.f, TWO_PI_F);
    const float iph = draw_range(rng, true, 0.f, PI_F);
    const float iplan = ir * fsin(iph);
    ndx = iplan * fcos(ith);
    ndy = iplan * fsin(ith);
    ndz = ir * fcos(iph);
  }
  const bool did_scatter = hit && !is_light && (!is_metal || metal_alive);

  // ---- sky (render.hpp:83-87) --------------------------------------------
  const float sky_tv = 0.5f * (udy + 1.f);
  o.rng = rng;
  o.hit = hit;
  o.miss = !hit;
  o.px = px;
  o.py = py;
  o.pz = pz;
  o.alb_x = alb_x;
  o.alb_y = alb_y;
  o.alb_z = alb_z;
  o.tk_image = tk_image;
  o.att_x = is_light ? 1.f : alb_x;
  o.att_y = is_light ? 1.f : alb_y;
  o.att_z = is_light ? 1.f : alb_z;
  o.did_scatter = did_scatter;
  o.ndx = ndx;
  o.ndy = ndy;
  o.ndz = ndz;
  o.stop_emit = is_light && !did_scatter;
  o.sky_x = 1.f - sky_tv + sky_tv * 0.5f;
  o.sky_y = 1.f - sky_tv + sky_tv * (float)0.7;
  o.sky_z = 1.f - sky_tv + sky_tv * 1.f;
  o.wscan = w.scan;
  o.wcls = w.cls;
  o.t_hit = t_hit;
}

// The inputs of one lane, read in one round of loads.
struct LaneIn {
  float f[N_IN];
  float fix[N_FIX];
  unsigned int rng;
  int texel;
  float srv;
};

__device__ __forceinline__ void load_lane(const WaveArgs& A, int i,
                                          LaneIn& L) {
#pragma unroll
  for (int p = 0; p < N_IN; ++p) L.f[p] = A.f_in[p][i];
#pragma unroll
  for (int p = 0; p < N_FIX; ++p) L.fix[p] = A.fix_in[p][i];
  L.rng = (unsigned int)A.rng_in[i];
  L.texel = A.texel[i];
  L.srv = A.srv[i];
}

// One bounce for lane i: fixup, stall, segment, termination, depth
// exhaustion, next fixup, win record, in-chunk regeneration, work count
// (bounce_core.wave_step).  An advancing lane's sphere fold has run
// already: (bk, bidx, snap) is its result.
template <int NMED, class Snaps>
__device__ __forceinline__ void lane_bounce(const WaveArgs& A, const int i,
                                            const LaneIn& L,
                                            const float bk, const int bidx,
                                            const Snaps& snap) {
#define IN(p) L.f[p]
  const float ox = IN(OX), oy = IN(OY), oz = IN(OZ);
  const float dx = IN(DX), dy = IN(DY), dz = IN(DZ), tm = IN(TM);
  const unsigned int rng = L.rng;
  float tpx = IN(TPX), tpy = IN(TPY), tpz = IN(TPZ);
  const bool alive_b = IN(ALIVE) > 0.f;

  // ---- apply the deferred fixup (texture.hpp:144-150, scale 1/255) -------
  const int tex = L.texel;
  const float txr = (float)(tex & 0xFF) * INV255_F;
  const float txg = (float)((tex >> 8) & 0xFF) * INV255_F;
  const float txb = (float)((tex >> 16) & 0xFF) * INV255_F;
  const float fk_in = L.fix[FK];
  const bool pend = fk_in != 0.f;
  const bool srvb = pend && (L.srv > 0.f);
  const bool stall = pend && !srvb;
  const bool is_alb_fix = srvb && fk_in == 1.f;
  const bool is_emit_fix = srvb && fk_in == 2.f;
  const float fwx_in = L.fix[FWX], fwy_in = L.fix[FWY],
              fwz_in = L.fix[FWZ];
  if (is_alb_fix) {
    tpx = tpx * txr;
    tpy = tpy * txg;
    tpz = tpz * txb;
  }
  const float acc_x0 = IN(ACCX) + (is_emit_fix ? fwx_in * txr : 0.f);
  const float acc_y0 = IN(ACCY) + (is_emit_fix ? fwy_in * txg : 0.f);
  const float acc_z0 = IN(ACCZ) + (is_emit_fix ? fwz_in * txb : 0.f);

  // ---- one segment; dead and stalled lanes skip it -----------------------
  const bool alive_adv = alive_b && !stall;
  Adv adv = {};  // a lane that does not advance: no hit, atlas index 0
  adv.rng = rng;
  if (alive_adv)
    advance<NMED>(A, i, ox, oy, oz, dx, dy, dz, tm, rng, bk, bidx, snap,
                  adv);

  // ---- termination and sky (render.hpp:58-91) ----------------------------
  float rxv = IN(RADX) + (adv.miss ? tpx * adv.sky_x : 0.f);
  float ryv = IN(RADY) + (adv.miss ? tpy * adv.sky_y : 0.f);
  float rzv = IN(RADZ) + (adv.miss ? tpz * adv.sky_z : 0.f);
  // emission on scatter-fail is unattenuated in the reference (render.hpp:73)
  const float ew_x = A.attenuate ? tpx : 1.f;
  const float ew_y = A.attenuate ? tpy : 1.f;
  const float ew_z = A.attenuate ? tpz : 1.f;
  const bool emit_inline = adv.stop_emit && !adv.tk_image;
  rxv = rxv + (emit_inline ? ew_x * adv.alb_x : 0.f);
  ryv = ryv + (emit_inline ? ew_y * adv.alb_y : 0.f);
  rzv = rzv + (emit_inline ? ew_z * adv.alb_z : 0.f);

  const bool cont = adv.did_scatter;
  const float tpx_n = cont ? tpx * adv.att_x : tpx;
  const float tpy_n = cont ? tpy * adv.att_y : tpy;
  const float tpz_n = cont ? tpz * adv.att_z : tpz;

  // ---- depth exhaustion --------------------------------------------------
  const float bnc = IN(BNC);
  const float bnc_n = alive_adv ? bnc + 1.f : bnc;
  const bool exhausted = cont && (bnc_n >= (float)A.max_depth);
  const bool alive_n = cont && !exhausted;
  const bool finished = alive_adv && !alive_n;
  const float acx_n = acc_x0 + (finished ? rxv : 0.f);
  const float acy_n = acc_y0 + (finished ? ryv : 0.f);
  const float acz_n = acc_z0 + (finished ? rzv : 0.f);

  // ---- next fixup (ALBEDO only for a path that goes on, render.hpp:91) ---
  const float fk = (alive_n && adv.tk_image) ? 1.f
                   : ((adv.stop_emit && adv.tk_image) ? 2.f : 0.f);
  A.fix_out[FK][i] = stall ? fk_in : fk;
  A.fix_out[FIDX][i] = stall ? L.fix[FIDX] : adv.atlas_idx;
  A.fix_out[FWX][i] = stall ? fwx_in : ew_x;
  A.fix_out[FWY][i] = stall ? fwy_in : ew_y;
  A.fix_out[FWZ][i] = stall ? fwz_in : ew_z;

  // ---- win record ((term*4 + cls)*1024 + scan) + 1; 0 = did not advance --
  const float term = adv.miss ? 1.f
                     : adv.stop_emit ? 2.f
                     : (adv.hit && !(adv.did_scatter || adv.stop_emit)) ? 3.f
                     : exhausted ? 4.f : 0.f;
  A.win[i] = alive_adv ? (term * 4.f + adv.wcls) * 1024.f + adv.wscan + 1.f
                       : 0.f;
  A.t_hit[i] = adv.t_hit;

  // ---- in-chunk regeneration (next sample of this pixel) -----------------
  const float sv = IN(S);
  const float s_next = sv + IN(STRD);
  const bool regen = (finished || !alive_b) && (s_next < IN(SEND)) && !stall;
  const float s_n = regen ? s_next : sv;
  float nox = cont ? adv.px : ox, noy = cont ? adv.py : oy,
        noz = cont ? adv.pz : oz;
  float ndx = cont ? adv.ndx : dx, ndy = cont ? adv.ndy : dy,
        ndz = cont ? adv.ndz : dz;
  float ntm = tm;
  unsigned int rng_n = adv.rng;
  if (regen) {  // camera.hpp:93-100 + render.hpp:96-97, as camera_rays
    const float* C = A.cam;
    const float pix = IN(PIX);
    const unsigned int pix_u = (unsigned int)(long long)pix;
    const unsigned int s_u = (unsigned int)(long long)tmax(s_n, 0.f);
    unsigned int st0 = splitmix32(pix_u ^ splitmix32(s_u ^ A.seed));
    rng_n = st0 == 0u ? INITIAL_STATE : st0;
    const float W = ld(&C[21]), H = ld(&C[22]);
    const float pyf = floorf((pix + 0.5f) * (1.f / W));
    const float pxf = pix - pyf * W;
    const float ju = draw(rng_n, true);
    const float jv = draw(rng_n, true);
    const float su = (pxf + ju) / W;
    const float sv_ = (pyf + jv) / H;
    const float dkx = draw_range(rng_n, true, -1.f, 1.f);
    const float dmaxy = sqrtf(1.f - dkx * dkx);
    const float df = draw(rng_n, true);
    const float dky = -dmaxy + (dmaxy - (-dmaxy)) * df;
    const float rdx = dkx * ld(&C[18]);
    const float rdy = dky * ld(&C[18]);
    const float offx = ld(&C[12]) * rdx + ld(&C[15]) * rdy;
    const float offy = ld(&C[13]) * rdx + ld(&C[16]) * rdy;
    const float offz = ld(&C[14]) * rdx + ld(&C[17]) * rdy;
    nox = ld(&C[0]) + offx;
    noy = ld(&C[1]) + offy;
    noz = ld(&C[2]) + offz;
    ndx = ld(&C[3]) + ld(&C[6]) * su + ld(&C[9]) * sv_ - ld(&C[0]) - offx;
    ndy = ld(&C[4]) + ld(&C[7]) * su + ld(&C[10]) * sv_ - ld(&C[1]) - offy;
    ndz = ld(&C[5]) + ld(&C[8]) * su + ld(&C[11]) * sv_ - ld(&C[2]) - offz;
    ntm = draw_range(rng_n, true, ld(&C[19]), ld(&C[20]));
  }
#define OUT(p) A.f_out[p][i]
  OUT(OX) = nox;
  OUT(OY) = noy;
  OUT(OZ) = noz;
  OUT(DX) = ndx;
  OUT(DY) = ndy;
  OUT(DZ) = ndz;
  OUT(TM) = ntm;
  A.rng_out[i] = (long long)rng_n;
  OUT(TPX) = regen ? 1.f : tpx_n;
  OUT(TPY) = regen ? 1.f : tpy_n;
  OUT(TPZ) = regen ? 1.f : tpz_n;
  OUT(RADX) = (regen || finished) ? 0.f : rxv;
  OUT(RADY) = (regen || finished) ? 0.f : ryv;
  OUT(RADZ) = (regen || finished) ? 0.f : rzv;
  OUT(ACCX) = acx_n;
  OUT(ACCY) = acy_n;
  OUT(ACCZ) = acz_n;
  OUT(ALIVE) = (alive_n || regen || (stall && alive_b)) ? 1.f : 0.f;
  OUT(S) = s_n;
  OUT(BNC) = regen ? 0.f : bnc_n;
  OUT(WRK) = IN(WRK) + (alive_adv ? 1.f : 0.f);
#undef OUT
#undef IN
}

constexpr int BLOCK = 256;       // threads a block
constexpr int WARPS = BLOCK / 32;
constexpr unsigned CHUNK = 32768;  // bytes a bulk copy of the fold table

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage the fold table in shared memory: one thread initialises the
// mbarrier, arms it with the byte count and issues the bulk copies, which
// complete on it.
__device__ __forceinline__ void stage_fold(const WaveArgs& A, float4* tab,
                                           unsigned bar) {
  const unsigned bytes = static_cast<unsigned>(A.fold_recs) * 16u;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  const char* src = reinterpret_cast<const char*>(A.fold);
  for (unsigned off = 0; off < bytes; off += CHUNK) {
    const unsigned n = bytes - off < CHUNK ? bytes - off : CHUNK;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(tab) + off),
        "l"(src + off), "r"(n), "r"(bar)
        : "memory");
  }
}

// Wait for the phase `parity` of the mbarrier to complete.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One bounce for every lane.  Block b takes lanes [b*span, (b+1)*span)
// and walks over them in tiles of BLOCK / K lanes: one thread a lane
// decides which lanes advance and packs their rays densely, K threads a
// lane fold the spheres, one thread a lane does the rest.
//   K = 1 (wide calls, bound by the fold's issue rate): 4 resident blocks
// of 64 registers, and a lane's inputs are read after the fold, so they
// hold no registers during it.
//   K > 1 (narrow calls, bound by latency): 3 resident blocks of 80
// registers, and a lane's inputs are read in one round of loads at the
// start of its tile.
//   NMED_GLOBAL (K = 1 only): the fold reads A.fold in place, nothing is
// staged, and the sphere snapshots of dense entry e go to scratch plane 0
// at lane t0 + e (inside the tile, so inside the block's span).
template <int NMED, int K>
__global__ void __launch_bounds__(BLOCK, K == 1 ? 4 : 3)
    wave_kernel(const WaveArgs A, const int span) {
  constexpr int TILE = BLOCK / K;
  constexpr bool EARLY = K > 1;  // the lane's inputs read before the fold
  constexpr bool GLOBAL = NMED == NMED_GLOBAL;
  static_assert(!GLOBAL || K == 1, "the global variant folds at K = 1");
  const int nm = media<NMED>(A.n_med);
  // the fold table, then (NMED = 0) the sphere snapshots
  extern __shared__ __align__(16) float4 s_tab[];
  __shared__ float s_ray[9][TILE];  // o, d, tm, a, t_min*a of the advancing
  __shared__ float s_bk[TILE];      // the fold's result, per dense entry
  __shared__ int s_bidx[TILE];
  __shared__ float s_snap[NMED > 0 ? NMED : 1][NMED > 0 ? TILE : 1];
  __shared__ int s_count[2][WARPS];  // by tile parity: no sync to reuse it
  __shared__ __align__(8) unsigned long long s_bar;
  // the sphere snapshot of medium m for dense entry e: snap_sh[m * TILE + e]
  float* const snap_sh = NMED > 0
                             ? &s_snap[0][0]
                             : reinterpret_cast<float*>(s_tab + A.fold_recs);
  // where the fold reads its table
  const float4* const tab = GLOBAL ? A.fold : s_tab;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned bar = smem_u32(&s_bar);
  // The table is copied at the first tile with an advancing lane, so a
  // block with none (narrow drain calls) never copies it.
  bool issued = false;  // the same in every thread of the block
  bool staged = false;  // this thread has seen the copy complete
  const int lo = blockIdx.x * span;
  const int hi = min(lo + span, A.n_lanes);
  for (int t0 = lo, parity = 0; t0 < hi; t0 += TILE, parity ^= 1) {
    const int i = t0 + tid;
    const bool mine = tid < TILE && i < hi;

    // ---- which lanes advance (lane_bounce's alive_adv), packed densely --
    LaneIn in;
    const auto plane = [&](int p) { return EARLY ? in.f[p] : A.f_in[p][i]; };
    bool adv = false;
    if (mine) {
      if (EARLY) load_lane(A, i, in);
      const float fk_in = EARLY ? in.fix[FK] : A.fix_in[FK][i];
      const bool stall = fk_in != 0.f && !((EARLY ? in.srv : A.srv[i]) > 0.f);
      adv = plane(ALIVE) > 0.f && !stall;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, adv);
    if (lane == 0) s_count[parity][warp] = __popc(ball);
    __syncthreads();
    int before = 0, n_adv = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_count[parity][w];
      before += w < warp ? c : 0;
      n_adv += c;
    }
    int pos = -1;
    if (n_adv > 0) {  // the same in every thread of the block
      if (!issued) {
        if (!GLOBAL && tid == 0) stage_fold(A, s_tab, bar);
        issued = true;
      }
      if (adv) {
        pos = before + __popc(ball & ((1u << lane) - 1u));
        const float dx = plane(DX), dy = plane(DY), dz = plane(DZ);
        const float a = dx * dx + dy * dy + dz * dz;
        s_ray[0][pos] = plane(OX);
        s_ray[1][pos] = plane(OY);
        s_ray[2][pos] = plane(OZ);
        s_ray[3][pos] = dx;
        s_ray[4][pos] = dy;
        s_ray[5][pos] = dz;
        s_ray[6][pos] = plane(TM);
        s_ray[7][pos] = a;
        s_ray[8][pos] = A.t_min * a;
      }
      __syncthreads();

      // ---- the sphere fold, K threads a dense entry ---------------------
      if (warp * (32 / K) < n_adv) {  // the warp holds a live entry
        if (!GLOBAL && !staged) {
          mbar_wait(bar, 0);
          staged = true;
        }
        const int e = tid / K, sub = tid % K;
        float bk = INF;
        int bidx = 0;
        typename SnapStore<NMED>::type snap;
        SnapStore<NMED>::bind(snap, A, 0, t0 + e);
        if (!GLOBAL) {  // (GLOBAL: fold_share writes every snapshot)
#pragma unroll
          for (int m = 0; m < nm; ++m) snap[m] = INF;
        }
        if (e < n_adv) {
          const FoldRay r{s_ray[0][e], s_ray[1][e], s_ray[2][e],
                          s_ray[3][e], s_ray[4][e], s_ray[5][e],
                          s_ray[6][e], s_ray[7][e], s_ray[8][e]};
          fold_share<NMED, K>(tab, A.sph_segs, nm, sub, r, bk, bidx, snap);
        }
        if (K > 1) reduce_split<NMED, K>(nm, bk, bidx, snap);
        if (e < n_adv && sub == 0) {
          s_bk[e] = bk;
          s_bidx[e] = bidx;
          if (!GLOBAL) {
#pragma unroll
            for (int m = 0; m < nm; ++m) snap_sh[m * TILE + e] = snap[m];
          }
        }
      }
      __syncthreads();
    }

    // ---- the rest, one thread a lane ------------------------------------
    if (mine) {
      float bk = INF;
      int bidx = 0;
      typename SnapStore<NMED>::type snap;
      // GLOBAL: the fold's column, read only by a lane that advanced
      SnapStore<NMED>::bind(snap, A, 0, t0 + (pos >= 0 ? pos : 0));
      if (!GLOBAL) {
#pragma unroll
        for (int m = 0; m < nm; ++m) snap[m] = INF;
      }
      if (pos >= 0) {
        bk = s_bk[pos];
        bidx = s_bidx[pos];
        if (!GLOBAL) {
#pragma unroll
          for (int m = 0; m < nm; ++m) snap[m] = snap_sh[m * TILE + pos];
        }
      }
      if (!EARLY) load_lane(A, i, in);
      lane_bounce<NMED>(A, i, in, bk, bidx, snap);
    }
  }
  // the copy must land before the block's shared memory is released
  if (!GLOBAL && issued && !staged) mbar_wait(bar, 0);
}

// Launch one bounce, or with `per_sm` set only report the resident blocks
// an SM for these arguments.
template <int NMED, int K>
cudaError_t run(const WaveArgs& a, cudaStream_t stream, int* per_sm) {
  const auto kern = wave_kernel<NMED, K>;
  const int smem =
      NMED == NMED_GLOBAL
          ? 0
          : a.fold_recs * 16 + (NMED > 0 ? 0 : a.n_med * (BLOCK / K) * 4);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return err;
  int dev = 0, sms = 0, blocks = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks, kern, BLOCK, smem)) != cudaSuccess)
    return err;
  if (per_sm != nullptr) {
    *per_sm = blocks;
    return cudaSuccess;
  }
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  // Every resident block takes an equal span of lanes, a multiple of a
  // warp's lanes (or of the tile, if smaller); its last tile may be part
  // full.  So no block is left with a whole extra tile at the end.
  const int tile = BLOCK / K, quantum = tile < 32 ? tile : 32;
  const int n_tiles = (a.n_lanes + tile - 1) / tile;
  const int grid0 = n_tiles < sms * blocks ? n_tiles : sms * blocks;
  const int per = (a.n_lanes + grid0 - 1) / grid0;
  const int span = (per + quantum - 1) / quantum * quantum;
  const int grid = (a.n_lanes + span - 1) / span;
  kern<<<grid, BLOCK, smem, stream>>>(a, span);
  return cudaGetLastError();
}

template <int NMED>
cudaError_t run_split(const WaveArgs& a, cudaStream_t stream, int* per_sm) {
  switch (a.split) {
    case 1: return run<NMED, 1>(a, stream, per_sm);
    case 2: return run<NMED, 2>(a, stream, per_sm);
    case 4: return run<NMED, 4>(a, stream, per_sm);
    case 8: return run<NMED, 8>(a, stream, per_sm);
    case 16: return run<NMED, 16>(a, stream, per_sm);
    case 32: return run<NMED, 32>(a, stream, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run_any(const WaveArgs& a, cudaStream_t stream, int* per_sm) {
  if (a.global)
    return a.split == 1 ? run<NMED_GLOBAL, 1>(a, stream, per_sm)
                        : cudaErrorInvalidValue;
  switch (a.n_med) {
    case 1: return run_split<1>(a, stream, per_sm);
    case 2: return run_split<2>(a, stream, per_sm);
    case 3: return run_split<3>(a, stream, per_sm);
    case 4: return run_split<4>(a, stream, per_sm);
    default:
      return a.n_med > 4 && a.n_med <= MAX_MED
                 ? run_split<0>(a, stream, per_sm)
                 : cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch one bounce on `stream`; returns cudaGetLastError() after the
// launch (0 = launched).  Media counts 1..4, the run-time count (5..MAX_MED)
// and K = 1, 2, 4, ..., 32 are instantiated, and NMED_GLOBAL at K = 1.
extern "C" int wave_bounce_launch(const WaveArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  return (int)run_any(*a, static_cast<cudaStream_t>(stream), nullptr);
}

// The resident blocks an SM of the instantiation `a` selects (n_med,
// split) with its fold table, in *blocks; returns the CUDA error code.
extern "C" int wave_bounce_occupancy(const WaveArgs* a, int* blocks) {
  return (int)run_any(*a, nullptr, blocks);
}

extern "C" const char* wave_bounce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
