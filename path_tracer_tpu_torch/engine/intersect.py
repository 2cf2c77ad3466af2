"""Branchless vectorized ray-scene intersection: the oracle engine's.

Mirrors the reference package's `engine/intersect.py`.  The reference's
per-ray linear scan with variant dispatch (render.hpp:30-51) becomes, for
a batch of N lanes and a primitive class of P entries, an (N, P) matrix
of candidate hit distances and a reduction:

* the scan accepts a hit only if strictly closer than the closest so far,
  so the winner is the least t with ties broken by scan position and box
  side, by class-dependent rules (`_merge`, `_class_best`);
* sphere roots are chosen against the global window [t_min, inf), which
  the ordered roots make equivalent to the shrinking-window scan;
* the smoke medium draws RNG during the scan and clamps its interval to
  the closest hit so far at its scan position (constant_medium.hpp:28-77):
  per medium, the minimum over primitives of a smaller scan index is
  taken again from the t matrices (`media_events`), and the masked draw
  advances exactly the reference's lanes.

Non-finite candidate t values (a ray parallel to a rect's plane) count as
misses, as in the reference.

Rounding: every op is one float32 op in the reference's order; sqrt, log,
atan2 and asin are evaluated in float64 and rounded once (`core.vec`),
where the reference calls XLA's float32 functions, so the two differ by
an ulp on some lanes and a knife-edge lane may flip a texel: images are
compared with an envelope.  The factorized sphere kernel's four (N,3) x
(3,P) products are written as broadcast multiply-adds in float32, never a
TF32 matrix product.

The (N, P) intermediates are large on the card (one float32 matrix of
480,000 lanes by 496 spheres is ~0.95 GB); they are freed as the fold
goes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..core import rng as rng_mod
from ..core.rng import f32
from ..core.vec import (Vec3, cross, dot, fasin, fatan2, fdiv, flog, fsqrt,
                        length, where as vwhere)
from ..scene import types as T

INF = float("inf")
BIG_SCAN = 2 ** 30

CLASS_SPHERE = 0
CLASS_RECT = 1
CLASS_TRI = 2
CLASS_MEDIUM = 3

_PI = f32(rng_mod.PI)
_EPS4 = f32(1e-4)


class Hit(NamedTuple):
    """Vectorized hit_record (hitable.hpp:8-24) plus material id."""
    hit: torch.Tensor          # bool (N,)
    t: torch.Tensor            # f32 (N,)
    p: Vec3                    # hit point
    normal: Vec3               # front-facing normal
    front_face: torch.Tensor   # bool
    u: torch.Tensor
    v: torch.Tensor
    mat: torch.Tensor          # int32 material id
    cls: torch.Tensor          # int32 winning class (CLASS_*)


class _Best(NamedTuple):
    t: torch.Tensor
    scan: torch.Tensor
    sub: torch.Tensor
    cls: torch.Tensor
    idx: torch.Tensor
    tie: torch.Tensor   # bool: wins ties when later in scan order (_merge)


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane rows of a per-primitive table (the reference's
    `gather_rows`, a column at a time).  `index_select`, not `table[idx]`:
    its backward is an `index_add_`, where indexing's backward on the card
    sorts the lane indices and adds each run of duplicates in turn, 32 ms
    a call at 480,000 lanes (84% of a differentiable bounce's device time
    on an H100).  The values are the same gather."""
    return torch.index_select(table, 0, idx)


def _col(v: Vec3) -> Vec3:
    """(N,) lanes -> (N, 1) for broadcasting against (P,) tables."""
    return Vec3(v.x[:, None], v.y[:, None], v.z[:, None])


def _inf_like(t: torch.Tensor) -> torch.Tensor:
    return torch.full_like(t, INF)


def _merge(a: _Best, b: _Best) -> _Best:
    """The reference scan's replacement rule with its class-dependent tie
    behaviour: spheres accept STRICTLY closer hits (sphere.hpp:76), so a
    later sphere never wins a t tie, while rects, triangles and media use
    the reject form (rectangle.hpp:35, triangle.hpp:90), so a later such
    hit replaces an equal-t best.  On a tie the later-scanned entry wins
    iff its `tie` flag is set."""
    tie_t = b.t == a.t
    b_later = (b.scan > a.scan) | ((b.scan == a.scan) & (b.sub > a.sub))
    b_wins = (b.t < a.t) | (tie_t & torch.where(b_later, b.tie, ~a.tie))
    pick = lambda x, y: torch.where(b_wins, y, x)
    return _Best(*(pick(x, y) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# Per-class candidate t matrices
# ---------------------------------------------------------------------------

def _motion_k(time0: torch.Tensor, time1: torch.Tensor,
              rtime: torch.Tensor) -> torch.Tensor:
    """(rtime - t0) / (t1 - t0), 0 for a static sphere (sphere.hpp:51-56)."""
    denom = time1 - time0
    static = denom == 0.0
    return torch.where(static, 0.0, (rtime - time0)
                       / torch.where(static, 1.0, denom))


def _sphere_roots(b: torch.Tensor, a: torch.Tensor, cc: torch.Tensor,
                  active: torch.Tensor, t_min: float, t_max: float
                  ) -> torch.Tensor:
    """The first root in (t_min, t_max), else the second, else inf, of the
    quadratic with half-b `b`: the strict accept of sphere.hpp:76,92."""
    disc = b * b - a * cc
    has_roots = disc > 0.0
    # fill 1.0, not 0.0: sqrt(0) has an infinite gradient, and the masked
    # lanes would poison the backward pass with inf * 0 = NaN
    sq = fsqrt(torch.where(has_roots, disc, 1.0))
    del disc
    t1 = (-b - sq) / a
    t2 = (-b + sq) / a
    del sq
    ok1 = (t1 > t_min) & (t1 < t_max)
    ok2 = (t2 > t_min) & (t2 < t_max)
    t = torch.where(ok1, t1, torch.where(ok2, t2, INF))
    valid = has_roots & (ok1 | ok2) & active
    return torch.where(valid, t, INF)


def sphere_t_matrix(s: T.Spheres, ro: Vec3, rd: Vec3, rtime: torch.Tensor,
                    t_min: float, t_max: float) -> torch.Tensor:
    """(N, P) candidate t for the sphere class (inf = miss), the exact
    form (sphere.hpp:59-106): the quadratic in the unnormalised ray, the
    first root preferred, the moving centre lerped (sphere.hpp:51-56)."""
    ro, rd = _col(ro), _col(rd)
    k = _motion_k(s.time0, s.time1, rtime[:, None])
    c = Vec3(s.c0.x + k * (s.c1.x - s.c0.x),
             s.c0.y + k * (s.c1.y - s.c0.y),
             s.c0.z + k * (s.c1.z - s.c0.z))
    del k
    oc = ro - c
    del c
    a = dot(rd, rd)            # (N, 1)
    b = dot(oc, rd)            # (N, P)
    cc = dot(oc, oc) - s.radius * s.radius
    del oc
    return _sphere_roots(b, a, cc, s.active, t_min, t_max)


def _mm3(a: Vec3, b: Vec3) -> torch.Tensor:
    """(N, 3) @ (3, P) as broadcast float32 multiply-adds, so no TF32
    matrix product can enter it: (N,) lane components against (P,)."""
    return ((a.x[:, None] * b.x[None, :] + a.y[:, None] * b.y[None, :])
            + a.z[:, None] * b.z[None, :])


def sphere_t_matrix_mxu(s: T.Spheres, ro: Vec3, rd: Vec3,
                        rtime: torch.Tensor, t_min: float, t_max: float
                        ) -> torch.Tensor:
    """The factorized sphere intersection (`exact=False`): the quadratic's
    coefficients decompose into four (N,3) x (3,P) products (d.c0, d.dc,
    o.c0, o.dc) and per-lane and per-sphere scalars,

        b  = o.d - (d.c0 + k d.dc)
        c  = |o|^2 - 2(o.c0 + k o.dc) + |c0|^2 + 2k c0.dc + k^2|dc|^2 - r^2,

    which the reference runs on the TPU's matrix unit at full float32
    precision (bf16 flips ~17% of hit/miss pairs there).  Here each
    product is three broadcast multiply-adds in float32.  Its
    associations differ from the exact form's by ulps: this kernel serves
    the renderers that take `exact=False`."""
    dc = Vec3(s.c1.x - s.c0.x, s.c1.y - s.c0.y, s.c1.z - s.c0.z)
    o_d = dot(ro, rd)[:, None]
    d_d = dot(rd, rd)[:, None]
    o_o = dot(ro, ro)[:, None]
    c0_sq = (s.c0.x * s.c0.x + s.c0.y * s.c0.y + s.c0.z * s.c0.z)[None, :]
    c0_dc = (s.c0.x * dc.x + s.c0.y * dc.y + s.c0.z * dc.z)[None, :]
    dc_sq = (dc.x * dc.x + dc.y * dc.y + dc.z * dc.z)[None, :]
    r2 = (s.radius * s.radius)[None, :]
    k = _motion_k(s.time0[None, :], s.time1[None, :], rtime[:, None])

    b = o_d - (_mm3(rd, s.c0) + k * _mm3(rd, dc))
    cc = (o_o - 2.0 * (_mm3(ro, s.c0) + k * _mm3(ro, dc))
          + (c0_sq + 2.0 * k * c0_dc + k * k * dc_sq) - r2)
    del k
    disc = b * b - d_d * cc
    del cc
    has_roots = disc > 0.0
    sq = fsqrt(torch.where(has_roots, disc, 1.0))
    del disc
    inv_a = 1.0 / d_d
    t1 = (-b - sq) * inv_a
    t2 = (-b + sq) * inv_a
    del sq, b
    ok1 = (t1 > t_min) & (t1 < t_max)
    ok2 = (t2 > t_min) & (t2 < t_max)
    t = torch.where(ok1, t1, torch.where(ok2, t2, INF))
    valid = has_roots & (ok1 | ok2) & s.active
    return torch.where(valid, t, INF)


def _axis_select(axis: torch.Tensor, ro: Vec3, rd: Vec3):
    """Per rect axis, the ray's (o_k, d_k, o_a, d_a, o_b, d_b): k the
    plane's axis, (a, b) the in-plane axes in reference order."""
    is_xy = axis == T.RECT_XY
    is_xz = axis == T.RECT_XZ
    w = torch.where
    return (w(is_xy, ro.z, w(is_xz, ro.y, ro.x)),
            w(is_xy, rd.z, w(is_xz, rd.y, rd.x)),
            w(is_xy, ro.x, w(is_xz, ro.x, ro.y)),
            w(is_xy, rd.x, w(is_xz, rd.x, rd.y)),
            w(is_xy, ro.y, w(is_xz, ro.z, ro.z)),
            w(is_xy, rd.y, w(is_xz, rd.z, rd.z)))


def rect_t_matrix(r: T.Rects, ro: Vec3, rd: Vec3, t_min: float,
                  t_max: float) -> torch.Tensor:
    """(N, P) candidate t for rects of all three axes (rectangle.hpp:31-49
    and siblings): plane solve, bounds test, reject form."""
    o_k, d_k, o_a, d_a, o_b, d_b = _axis_select(r.axis, _col(ro), _col(rd))
    t = (r.k - o_k) / d_k
    in_range = ~((t < t_min) | (t > t_max))
    av = o_a + t * d_a
    bv = o_b + t * d_b
    in_bounds = ~((av < r.a0) | (av > r.a1) | (bv < r.b0) | (bv > r.b1))
    valid = in_range & in_bounds & r.active & torch.isfinite(t)
    return torch.where(valid, t, INF)


def triangle_t_matrix(tr: T.Triangles, ro: Vec3, rd: Vec3, t_min: float,
                      t_max: float) -> torch.Tensor:
    """(N, P) candidate t, Moller-Trumbore with the reference's sign-trick
    early outs as masks (triangle.hpp:58-100, eps 1e-7)."""
    ro, rd = _col(ro), _col(rd)
    e1 = tr.v1 - tr.v0
    e2 = tr.v2 - tr.v0
    h = cross(rd, e2)
    a = dot(e1, h)
    a_abs = torch.abs(a)
    not_parallel = a_abs >= f32(1e-7)
    a_pos = a > 0.0
    s = ro - tr.v0
    u = dot(s, h)
    u_ok = ~((u > 0.0) ^ a_pos) & (torch.abs(u) <= a_abs)
    q = cross(s, e1)
    v = dot(rd, q)
    v_ok = ~((v > 0.0) ^ a_pos) & (torch.abs(u + v) <= a_abs)
    t = dot(e2, q) / a
    in_range = ~((t < t_min) | (t > t_max))
    valid = not_parallel & u_ok & v_ok & in_range & tr.active
    return torch.where(valid, t, INF)


def triangle_t_matrix_badouel(tr: T.Triangles, ro: Vec3, rd: Vec3,
                              t_min: float, t_max: float) -> torch.Tensor:
    """(N, P) candidate t, Badouel's plane-then-barycentric strategy, the
    reference's alternate compile-time intersector (triangle.hpp:14-56,
    parallel cutoff 1e-6, an extra reject of t < 0)."""
    ro, rd = _col(ro), _col(rd)
    u = tr.v1 - tr.v0
    v = tr.v2 - tr.v0
    n = cross(u, v)
    w0 = ro - tr.v0
    a = -dot(n, w0)
    b = dot(n, rd)
    not_parallel = torch.abs(b) >= f32(1e-6)
    t = a / torch.where(not_parallel, b, 1.0)
    in_range = (t >= 0.0) & ~((t < t_min) | (t > t_max))
    # barycentric via the precomputed dot products (triangle.hpp:39-48)
    hp = ro + rd * t
    uu = dot(u, u)
    uv = dot(u, v)
    vv = dot(v, v)
    w = hp - tr.v0
    wu = dot(w, u)
    wv = dot(w, v)
    D = uv * uv - uu * vv
    D_safe = torch.where(D == 0.0, 1.0, D)
    s = (uv * wv - vv * wu) / D_safe
    tt = (uv * wu - uu * wv) / D_safe
    inside = ~((s < 0.0) | (s > 1.0) | (tt < 0.0) | (s + tt > 1.0))
    valid = not_parallel & in_range & inside & (D != 0.0) & tr.active
    return torch.where(valid, t, INF)


TRIANGLE_KERNELS = {
    "moller_trumbore": triangle_t_matrix,   # reference default
    "badouel": triangle_t_matrix_badouel,
}


def _class_best(t_mat: torch.Tensor, scan: torch.Tensor,
                sub: Optional[torch.Tensor], cls: int,
                tie_wins_later: bool) -> _Best:
    """Per-class argmin.  Tables are packed in scan order, so the first
    occurrence is the earliest scan entry and the last the latest: classes
    whose accept test passes at equality (rects, triangles) take the LAST
    tied minimum, spheres the first.  torch.argmin returns the first
    minimum, so the last is the first of the flipped matrix."""
    p = t_mat.shape[1]
    if tie_wins_later:
        idx = (p - 1) - torch.argmin(torch.flip(t_mat, (1,)), dim=1)
    else:
        idx = torch.argmin(t_mat, dim=1)
    t = torch.amin(t_mat, dim=1)   # the same value as t_mat[idx]
    hit = t < INF
    scan_i = scan.int()[idx]
    sub_i = (torch.where(hit, sub.int()[idx], 0) if sub is not None
             else torch.zeros_like(scan_i))
    return _Best(t=t, scan=torch.where(hit, scan_i, BIG_SCAN), sub=sub_i,
                 cls=torch.full_like(scan_i, cls), idx=idx.int(),
                 tie=torch.full_like(hit, tie_wins_later))


# ---------------------------------------------------------------------------
# Constant-medium boundary probing
# ---------------------------------------------------------------------------

def _sphere_boundary_roots(c: Vec3, r: torch.Tensor, ro: Vec3, rd: Vec3
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(hit2, t_entry, t_exit) of a static sphere boundary under the
    reference's two probes (constant_medium.hpp:34-50): the first over
    (-inf, inf) takes t1 whenever disc > 0, the second over
    (t1 + 1e-4, inf) needs t2 > t1 + 1e-4 (the strict accept)."""
    oc = ro - c
    a = dot(rd, rd)
    b = dot(oc, rd)
    cc = dot(oc, oc) - r * r
    disc = b * b - a * cc
    has = disc > 0.0
    sq = fsqrt(torch.where(has, disc, 1.0))
    t1 = (-b - sq) / a
    t2 = (-b + sq) / a
    return has & (t2 > t1 + _EPS4), t1, t2


def _box_boundary_roots(pmin: Vec3, pmax: Vec3, ro: Vec3, rd: Vec3
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Entry and exit of a box boundary: the closest hit over its 6 rect
    sides in box::hit's order (box.hpp:20-50) under the two probes of
    constant_medium.hpp:34-50."""
    sides = [
        # (plane origin, dir, a origin, dir, b origin, dir, k, a0, a1, b0, b1)
        (ro.z, rd.z, ro.x, rd.x, ro.y, rd.y, pmax.z, pmin.x, pmax.x, pmin.y,
         pmax.y),
        (ro.z, rd.z, ro.x, rd.x, ro.y, rd.y, pmin.z, pmin.x, pmax.x, pmin.y,
         pmax.y),
        (ro.y, rd.y, ro.x, rd.x, ro.z, rd.z, pmax.y, pmin.x, pmax.x, pmin.z,
         pmax.z),
        (ro.y, rd.y, ro.x, rd.x, ro.z, rd.z, pmin.y, pmin.x, pmax.x, pmin.z,
         pmax.z),
        (ro.x, rd.x, ro.y, rd.y, ro.z, rd.z, pmax.x, pmin.y, pmax.y, pmin.z,
         pmax.z),
        (ro.x, rd.x, ro.y, rd.y, ro.z, rd.z, pmin.x, pmin.y, pmax.y, pmin.z,
         pmax.z),
    ]
    ts = []
    for ok_, dk_, oa_, da_, ob_, db_, k_, a0_, a1_, b0_, b1_ in sides:
        t = (k_ - ok_) / dk_
        av = oa_ + t * da_
        bv = ob_ + t * db_
        ok = ~((av < a0_) | (av > a1_) | (bv < b0_) | (bv > b1_))
        ts.append(torch.where(ok & torch.isfinite(t), t, INF))
    tstack = torch.stack(ts)                  # (6, N)
    entry = torch.amin(tstack, dim=0)
    hit1 = entry < INF
    # second probe: min = entry + 1e-4; reject t < min (strict)
    second = torch.where(tstack < entry + _EPS4, INF, tstack)
    exit_t = torch.amin(second, dim=0)
    return hit1 & (exit_t < INF), entry, exit_t


def media_events(media: T.Media, ro: Vec3, rd: Vec3,
                 rng_state: torch.Tensor, prefix: _Best,
                 class_mats: List[Tuple[torch.Tensor, torch.Tensor]],
                 t_min: float, lane_mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, _Best]:
    """The media in scan order, as constant_medium.hpp:28-77 with its
    RNG-draw gating.  `prefix` is the best hit among the other classes;
    `class_mats` the (t matrix (N, P), scan (P,)) pairs from which each
    medium's closest-so-far is taken again: the minimum over primitives
    of a smaller scan index (render.hpp:37-49; the restriction of the
    global argmin is not that minimum), and the media events accepted
    before it.  Returns (rng_state, best including media)."""
    best = prefix
    # media are packed in scan order, so every earlier accepted event has
    # a smaller scan index: a running minimum suffices
    earlier_events_t = _inf_like(prefix.t)
    for i in range(media.r.shape[0]):
        c_i = Vec3(media.c.x[i], media.c.y[i], media.c.z[i])
        pmin_i = Vec3(media.pmin.x[i], media.pmin.y[i], media.pmin.z[i])
        pmax_i = Vec3(media.pmax.x[i], media.pmax.y[i], media.pmax.z[i])
        sph2, sph_in, sph_out = _sphere_boundary_roots(c_i, media.r[i], ro,
                                                       rd)
        box2, box_in, box_out = _box_boundary_roots(pmin_i, pmax_i, ro, rd)
        is_box = media.btype[i] == T.MED_BOUND_BOX
        hit2 = torch.where(is_box, box2, sph2) & media.active[i]
        t_in = torch.where(is_box, box_in, sph_in)
        t_out = torch.where(is_box, box_out, sph_out)

        # closest so far at this medium's scan position
        med_scan = media.scan[i]
        pre_t = _inf_like(prefix.t)
        for t_mat, scan_arr in class_mats:
            restricted = torch.where((scan_arr < med_scan)[None, :], t_mat,
                                     INF)
            pre_t = torch.minimum(pre_t, torch.amin(restricted, dim=1))
            del restricted
        pre_t = torch.minimum(pre_t, earlier_events_t)

        # clamp the interval (constant_medium.hpp:52-59): entry up to the
        # global t_min and to 0, exit down to the closest so far
        t1c = torch.clamp_min(torch.clamp_min(t_in, t_min), 0.0)
        t2c = torch.minimum(t_out, pre_t)
        interval_ok = ~(t1c >= t2c)

        draw_mask = lane_mask & hit2 & interval_ok
        rng_state, uni = rng_mod.next_f01(rng_state, draw_mask)
        # masked lanes carry a garbage draw (maybe 0): keep log() finite so
        # the backward pass w.r.t. neg_inv_density stays NaN-free
        uni = torch.where(draw_mask, uni, 0.5)

        ray_len = length(rd)
        dist_inside = (t2c - t1c) * ray_len
        hit_distance = media.neg_inv_density[i] * flog(uni)
        accept = draw_mask & ~(hit_distance > dist_inside)
        t_e = t1c + hit_distance / ray_len
        cand = _Best(
            t=torch.where(accept, t_e, INF),
            scan=torch.where(accept, med_scan.int(), BIG_SCAN),
            sub=torch.zeros_like(prefix.sub),
            cls=torch.full_like(prefix.cls, CLASS_MEDIUM),
            idx=torch.full_like(prefix.idx, i),
            # the caller replaces closest-so-far whenever hit() returns
            # true and the event t may equal the clamped bound: a later
            # equal t wins, as for the reject-form classes
            tie=torch.ones_like(prefix.tie))
        best = _merge(best, cand)
        earlier_events_t = torch.where(
            accept, torch.minimum(earlier_events_t, t_e), earlier_events_t)
    return rng_state, best


# ---------------------------------------------------------------------------
# Winner record reconstruction
# ---------------------------------------------------------------------------

def _set_face_normal(rd: Vec3, outward: Vec3
                     ) -> Tuple[torch.Tensor, Vec3]:
    """hitable.hpp:20-23."""
    front = dot(rd, outward) < 0.0
    return front, vwhere(front, outward, -outward)


def _mercator(n: Vec3) -> Tuple[torch.Tensor, torch.Tensor]:
    """sphere.hpp:13-24: uv from the face-flipped normal.  libm's atan2
    and asin in float64, rounded once (not the kernel's minimax atan)."""
    # atan2 has NaN partials at (0, 0): a safe x for those (masked) lanes
    degenerate = (n.x == 0.0) & (n.z == 0.0)
    phi = fatan2(n.z, torch.where(degenerate, 1.0, n.x))
    y = torch.clamp(n.y, -1.0, 1.0)
    interior = torch.abs(y) < 1.0
    theta = torch.where(interior, fasin(torch.where(interior, y, 0.0)),
                        torch.sign(y) * f32(_PI / 2.0))
    u = 1.0 - fdiv(phi + _PI, 2.0 * _PI)
    v = fdiv(theta + f32(_PI / 2.0), _PI)
    return u, v


def build_hit(scene: T.Scene, best: _Best, ro: Vec3, rd: Vec3,
              rtime: torch.Tensor) -> Hit:
    """The winner's hit record by the exact per-type formulas (O(N) work:
    the (N, P) pass produced only t, scan and index)."""
    hit = best.t < INF
    t = torch.where(hit, best.t, 0.0)
    p = ro + rd * t   # ray::at, ray.hpp:21
    idx = best.idx.long()

    # --- sphere record (sphere.hpp:74-99) ---
    s = scene.spheres
    si = torch.clamp(idx, 0, s.radius.shape[0] - 1)
    k = _motion_k(take(s.time0, si), take(s.time1, si), rtime)
    sc0 = Vec3(*(take(c, si) for c in s.c0))
    sc1 = Vec3(*(take(c, si) for c in s.c1))
    c = sc0 + (sc1 - sc0) * k
    srad = take(s.radius, si)
    # a lane whose winner is another class (or a miss) may gather a padded
    # sphere row of radius 0: dividing by it poisons the backward pass
    outward_s = (p - c) / torch.where(srad == 0.0, 1.0, srad)
    front_s, n_s = _set_face_normal(rd, outward_s)
    u_s, v_s = _mercator(n_s)

    # --- rect record (rectangle.hpp:31-49) ---
    r = scene.rects
    ri = torch.clamp(idx, 0, r.k.shape[0] - 1)
    axis = take(r.axis, ri)
    _, _, o_a, d_a, o_b, d_b = _axis_select(axis, ro, rd)
    a0, a1, b0, b1 = (take(x, ri) for x in (r.a0, r.a1, r.b0, r.b1))
    u_r = (o_a + t * d_a - a0) / (a1 - a0)
    v_r = (o_b + t * d_b - b0) / (b1 - b0)
    is_xy = axis == T.RECT_XY
    is_xz = axis == T.RECT_XZ
    zero = torch.zeros_like(t)
    one = torch.ones_like(t)
    outward_r = Vec3(torch.where(is_xy | is_xz, zero, one),
                     torch.where(is_xz, one, zero),
                     torch.where(is_xy, one, zero))
    front_r, n_r = _set_face_normal(rd, outward_r)

    # --- triangle record (triangle.hpp:94-99; the reference's u, v are
    # stale there, defined as 0 here as in the reference package) ---
    tr = scene.triangles
    ti = torch.clamp(idx, 0, tr.mat.shape[0] - 1)
    tv0 = Vec3(*(take(c, ti) for c in tr.v0))
    tv1 = Vec3(*(take(c, ti) for c in tr.v1))
    tv2 = Vec3(*(take(c, ti) for c in tr.v2))
    front_t, n_t = _set_face_normal(rd, cross(tv1 - tv0, tv2 - tv0))

    # --- medium record (constant_medium.hpp:72-76): normal (1, 0, 0),
    # front_face true, the phase function's material ---
    m = scene.media
    mi = torch.clamp(idx, 0, m.mat.shape[0] - 1)

    is_s = best.cls == CLASS_SPHERE
    is_r = best.cls == CLASS_RECT
    is_t = best.cls == CLASS_TRI

    def sel(a, b, c_, d_):
        return torch.where(is_s, a, torch.where(is_r, b,
                                                torch.where(is_t, c_, d_)))

    normal = Vec3(sel(n_s.x, n_r.x, n_t.x, one),
                  sel(n_s.y, n_r.y, n_t.y, zero),
                  sel(n_s.z, n_r.z, n_t.z, zero))
    front = sel(front_s, front_r, front_t, torch.ones_like(hit))
    u = sel(u_s, u_r, zero, zero)
    v = sel(v_s, v_r, zero, zero)
    mat = sel(take(s.mat, si).int(), take(r.mat, ri).int(),
              take(tr.mat, ti).int(), take(m.mat, mi).int())
    return Hit(hit=hit, t=t, p=p, normal=normal, front_face=front, u=u, v=v,
               mat=torch.where(hit, mat, 0), cls=best.cls)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def intersect_scene(scene: T.Scene, ro: Vec3, rd: Vec3, rtime: torch.Tensor,
                    rng_state: torch.Tensor, lane_mask: torch.Tensor,
                    t_min: float = 1e-3, exact: bool = True,
                    triangle_algorithm: str = "moller_trumbore"
                    ) -> Tuple[torch.Tensor, Hit]:
    """hit_world (render.hpp:30-51) for a ray batch on the rays' device.
    `lane_mask` gates the media RNG draws of dead lanes (their streams must
    not advance).  exact=True takes the reference-association sphere
    kernel (parity), exact=False the factorized one (ulp-level
    differences)."""
    t_min = f32(t_min)
    sph_kernel = sphere_t_matrix if exact else sphere_t_matrix_mxu
    ts = sph_kernel(scene.spheres, ro, rd, rtime, t_min, INF)
    best_s = _class_best(ts, scene.spheres.scan, None, CLASS_SPHERE,
                         tie_wins_later=False)
    tr = rect_t_matrix(scene.rects, ro, rd, t_min, INF)
    tt = TRIANGLE_KERNELS[triangle_algorithm](scene.triangles, ro, rd,
                                              t_min, INF)
    best_r = _class_best(tr, scene.rects.scan, scene.rects.sub, CLASS_RECT,
                         tie_wins_later=True)
    best_t = _class_best(tt, scene.triangles.scan, None, CLASS_TRI,
                         tie_wins_later=True)
    prim_best = _merge(_merge(best_s, best_r), best_t)
    class_mats = [(ts, scene.spheres.scan), (tr, scene.rects.scan),
                  (tt, scene.triangles.scan)]
    del ts, tr, tt
    rng_state, best = media_events(scene.media, ro, rd, rng_state, prim_best,
                                   class_mats, t_min, lane_mask)
    del class_mats
    return rng_state, build_hit(scene, best, ro, rd, rtime)
