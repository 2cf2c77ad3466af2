"""Silhouette-aware gradients: edge sampling for sphere boundaries.

Mirrors the reference package's `diff/edge.py`, whose module docstring
derives the estimator.  In short: the interior (detached-sampling)
gradient of the differentiable integrator sees shading changes at fixed
visibility only; a sphere's radius and centre also move its silhouette,
a step in the image whose derivative is a line integral over the
silhouette curve {G = 0} in film space (s, t),

    dL/dtheta (boundary) = oint g(x) (f_in(x) - f_out(x)) v_perp dl,
    v_perp = (dG/dtheta) / |grad_(s,t) G|,

with G(s, t; theta) = (oc.d)^2 - |d|^2 (|oc|^2 - R^2) the hit
discriminant of the pinhole ray through (s, t) (sphere.hpp:59-66), g the
loss cotangent at x's pixel times W*H, and f_in / f_out the radiance just
inside and outside, estimated with the ordinary tracer
(`engine.integrator.trace`).  The silhouette is sampled at K angles of
the sphere's exact 3-D silhouette circle, each point projected through
the camera (a 3x3 solve against [horizontal, vertical, -dir]).

Where the reference takes `jax.vmap`, `jax.jacfwd` and `jax.grad`, the
port writes the derivatives in closed form over a batch of the K edge
points (torch.func's forward mode through a batched `linalg.solve` gave
NaN):

* the line element: with A = [H, V, -(p - o)] and A (s, t, lam) = o - llc,
  d(s, t, lam)/dphi = A^-1 (lam dp/dphi), dp/dphi = rho (-sin phi e1 +
  cos phi e2);
* the gradient of G = b^2 - a cc (b = oc.d, a = d.d, cc = oc.oc - R^2,
  oc = o - c, d = llc + s H + t V - o): dG/ds = 2b oc.H - 2 cc d.H,
  dG/dt = 2b oc.V - 2 cc d.V, dG/dc = 2a oc - 2b d, dG/dR = 2a R.

The radiance estimates run without autograd: the result is a gradient
term, not differentiated further.

Scope, as the reference's: primary-visibility silhouettes of spheres
through a pinhole camera (lens radius ~0), static spheres (or moving ones
at a fixed evaluation time); secondary discontinuities are out of scope.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..core import rng as rng_mod
from ..core.camera import Camera
from ..core.vec import Vec3
from ..engine.integrator import trace
from ..scene import types as T


class EdgeGrad(NamedTuple):
    """Boundary (silhouette) contribution to dL/dtheta for one sphere."""
    center: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # d/dc x, y, z
    radius: torch.Tensor


def _cam_vectors(cam: Camera, device: torch.device):
    st = lambda v: torch.stack([c.reshape(()) for c in v]).to(
        device=device, dtype=torch.float32).detach()
    return (st(cam.origin), st(cam.lower_left_corner), st(cam.horizontal),
            st(cam.vertical))


def _disc_grads(st, c, R, o, llc, Hv, Vv):
    """The gradients of G(s, t) = b^2 - a cc, the sphere-hit discriminant
    of the pinhole ray through (s, t) (sphere.hpp:60-66 with the
    camera.hpp:96-98 direction), at K film points st (K, 2): dG/ds,
    dG/dt (K,), dG/dc (K, 3) and dG/dR (K,)."""
    d = llc + st[:, :1] * Hv + st[:, 1:] * Vv - o          # (K, 3)
    oc = o - c
    b = d @ oc
    a = (d * d).sum(1)
    cc = torch.dot(oc, oc) - R * R
    gs = 2.0 * b * torch.dot(oc, Hv) - 2.0 * cc * (d @ Hv)
    gt = 2.0 * b * torch.dot(oc, Vv) - 2.0 * cc * (d @ Vv)
    gc = 2.0 * a[:, None] * oc - 2.0 * b[:, None] * d
    return gs, gt, gc, 2.0 * a * R


def _silhouette_points(o, c, R, K: int):
    """K points on the 3-D silhouette circle of sphere (c, R) seen from o,
    (K, 3), and their derivatives w.r.t. the angle."""
    m = c - o
    L = torch.sqrt(torch.dot(m, m))
    mh = m / L
    # the tangent circle: centre q, radius rho (cone geometry)
    q = c - (R * R / L) * mh
    rho = R * torch.sqrt(torch.clamp_min(1.0 - (R / L) ** 2, 0.0))
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=mh.dtype, device=mh.device)
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=mh.dtype, device=mh.device)
    ref = torch.where(torch.abs(mh[0]) < 0.9, x_axis, y_axis)
    e1 = torch.linalg.cross(mh, ref)
    e1 = e1 / torch.sqrt(torch.dot(e1, e1))
    e2 = torch.linalg.cross(mh, e1)

    phis = ((torch.arange(K, dtype=torch.float32, device=o.device) + 0.5)
            * torch.tensor(2.0 * math.pi / K, dtype=torch.float32))
    cos, sin = torch.cos(phis)[:, None], torch.sin(phis)[:, None]
    return q + rho * (cos * e1 + sin * e2), rho * (cos * e2 - sin * e1)


def _project(p, dp, o, llc, Hv, Vv):
    """Film coordinates (s, t) of world points p (K, 3) through the
    pinhole, solving o + lam (p - o) = llc + s H + t V (3 equations, 3
    unknowns), and their derivatives for the points' derivatives dp."""
    A = torch.stack([Hv.expand_as(p), Vv.expand_as(p), -(p - o)],
                    dim=2)                               # (K, 3, 3) columns
    sol = torch.linalg.solve(A, (o - llc).expand_as(p))
    dsol = torch.linalg.solve(A, dp * sol[:, 2:])
    return sol[:, :2], dsol[:, :2]


def sphere_silhouette_grad(scene: T.Scene, cam: Camera, width: int,
                           height: int, sphere_idx: int,
                           image_cotangent: torch.Tensor, *,
                           n_edge: int = 256, spp_edge: int = 32,
                           max_depth: int = 8, eps_px: float = 0.5,
                           attenuate_emission: bool = False,
                           t_min: float = 1e-3, seed: int = 7,
                           time: float = 0.0) -> EdgeGrad:
    """The boundary term of dL/d(centre, radius) for
    `scene.spheres[sphere_idx]`, on the scene's device.

    image_cotangent: (height, width, 3) dL/dI (e.g. all 1/(W*H*3) for the
    mean-of-image loss), row 0 = image bottom (the renderer's fb).  Returns
    the silhouette contribution only; add it to the interior gradient of
    the differentiable renderer to compare with finite differences."""
    dev = scene.spheres.radius.device
    o, llc, Hv, Vv = _cam_vectors(cam, dev)
    sph = scene.spheres
    c = torch.stack([sph.c0.x[sphere_idx], sph.c0.y[sphere_idx],
                     sph.c0.z[sphere_idx]]).detach()
    R = sph.radius[sphere_idx].detach()

    points, dpoints = _silhouette_points(o, c, R, n_edge)
    st, dst_dphi = _project(points, dpoints, o, llc, Hv, Vv)   # (K, 2)
    line_el = torch.sqrt(torch.sum(dst_dphi ** 2, dim=1))

    # gradients of G at the edge points: w.r.t. (s, t) and (c, R)
    gs, gt, gc, gR = _disc_grads(st, c, R, o, llc, Hv, Vv)
    grad_norm = torch.clamp_min(torch.sqrt(gs * gs + gt * gt), 1e-30)
    nhat = torch.stack([gs, gt], dim=1) / grad_norm[:, None]  # points inside

    # the radiance on both sides, eps half a pixel by default
    eps = torch.tensor(eps_px, dtype=torch.float32) / max(width, height)
    with torch.no_grad():
        f_in = _edge_radiance(scene, cam, st + eps * nhat, spp_edge,
                              max_depth, attenuate_emission, t_min, seed,
                              time)
        f_out = _edge_radiance(scene, cam, st - eps * nhat, spp_edge,
                               max_depth, attenuate_emission, t_min,
                               seed + 1, time)

    # the cotangent at each edge point's pixel (zero outside the frame)
    px = torch.floor(st[:, 0] * width).long()
    py = torch.floor(st[:, 1] * height).long()
    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    ct = (image_cotangent.to(dev)[torch.clamp(py, 0, height - 1),
                                  torch.clamp(px, 0, width - 1), :]
          * inside[:, None].float())
    gweight = float(width * height) * torch.sum(ct * (f_in - f_out), dim=1)

    # line integral: sum_k g.df (dG/dtheta)/|grad G| |x'| dphi
    dphi = torch.tensor(2.0 * math.pi / n_edge, dtype=torch.float32)
    base = gweight * line_el * dphi / grad_norm
    return EdgeGrad(center=tuple(torch.sum(base * gc[:, i])
                                 for i in range(3)),
                    radius=torch.sum(base * gR))


def _edge_radiance(scene, cam, st, spp, max_depth, attenuate_emission,
                   t_min, seed, time):
    """(K, 3) mean radiance of pinhole rays through film points st (K, 2):
    plain Monte Carlo with counter-seeded streams (`seed_perf` keyed on
    synthetic ids) through the ordinary tracer."""
    K = st.shape[0]
    dev = st.device
    o, llc, Hv, Vv = _cam_vectors(cam, dev)
    s = st[:, 0].repeat(spp)
    t = st[:, 1].repeat(spp)
    dirs = llc[None, :] + s[:, None] * Hv[None, :] + t[:, None] * Vv[None, :] \
        - o[None, :]
    n = K * spp
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    state = rng_mod.seed_perf(ids, torch.full_like(ids, seed), seed)
    ov = Vec3(*(torch.full((n,), float(x), device=dev) for x in o))
    dv = Vec3(dirs[:, 0], dirs[:, 1], dirs[:, 2])
    _, rad = trace(scene, ov, dv, torch.full((n,), float(time), device=dev),
                   state, max_depth, attenuate_emission, t_min)
    rgb = torch.stack([rad.x, rad.y, rad.z], dim=1).reshape(spp, K, 3)
    return rgb.mean(dim=0)
