"""The nearest-sphere kernel's (K2) partition of the work, mirrored in
PyTorch, against the plain version (`spike_pmat.spike_pmat_plain`), bit
for bit.  No JAX.

The kernel (`ops/csrc/spike_pmat.cu`: pmat_kernel, fold_group) gives a
block of BLOCK threads BLOCK / K ray groups of R = RAYS_A_THREAD rays:
thread t is thread
`sub` = t % K of group t / K, whose rays are the block's first ray + t / K
+ i * BLOCK / K (i < R), a ray past the end reading the last ray and
writing nothing.  Thread `sub` folds spheres sub, sub + K, ... with a
strict < (the first of equal keys stays), taking the roots only where
disc > 0; the K partial (key, index) pairs are then reduced by a shuffle
butterfly in lexicographic order.  `mirror` below does the same with the
K threads as a leading tensor dimension and every ray slot of the grid as
the second; every float op is the kernel's, so the result must equal the
plain version exactly, for every K: on the spike's inputs, on a table
whose keys tie (`make_tie_inputs`) and on degenerate rays
(`make_edge_inputs`: d = 0, an origin inside a sphere, disc exactly 0, a
ray count no block size divides).
"""
import math

import pytest
import torch

from path_tracer_tpu_torch.core.rng import f32
from path_tracer_tpu_torch.core.vec import fsqrt
from path_tracer_tpu_torch.ops import spike_pmat as SP

INF = math.inf


def mirror(tab, attrs, *planes, k, r=SP.RAYS_A_THREAD):
    """(t, meta) as the kernel computes them with K = k (and R = r)."""
    shape = planes[0].shape
    n = planes[0].numel()
    groups = SP.BLOCK // k
    blocks = -(-n // (groups * r))
    ray = (torch.arange(blocks)[:, None, None] * (groups * r)
           + torch.arange(groups)[None, :, None]
           + torch.arange(r)[None, None, :] * groups).reshape(-1)
    live = ray < n
    ox, oy, oz, dx, dy, dz, tm = (p.reshape(-1)[torch.clamp(ray, max=n - 1)]
                                  for p in planes)
    a = dx * dx + dy * dy + dz * dz
    tmin_a = f32(1e-3) * a
    best = torch.full((k, ray.numel()), INF)
    bidx = torch.zeros((k, ray.numel()), dtype=torch.long)
    sub = torch.arange(k)
    for j0 in range(0, SP.P, k):
        p = j0 + sub                                 # one sphere a thread
        c0x, c0y, c0z, dcx, dcy, dcz, t0, idt, r2 = (tab[p, q][:, None]
                                                     for q in range(9))
        kmov = (tm - t0) * idt
        cx = c0x + kmov * dcx
        cy = c0y + kmov * dcy
        cz = c0z + kmov * dcz
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = b * b - a * cc
        has = disc > 0.0                             # the branch
        sq = fsqrt(torch.where(has, disc, 1.0))
        negb = -b
        k1 = negb - sq
        k2 = negb + sq
        key = torch.where(k1 > tmin_a, k1, torch.where(k2 > tmin_a, k2, INF))
        take = has & (key < best)
        best = torch.where(take, key, best)
        bidx = torch.where(take, p[:, None], bidx)
    off = 1
    while off < k:                                   # the shuffle butterfly
        o = sub ^ off
        ok, oi = best[o], bidx[o]
        take = (ok < best) | ((ok == best) & (oi < bidx))
        best, bidx = torch.where(take, ok, best), torch.where(take, oi, bidx)
        off *= 2
    for x in (best, bidx):                           # every thread agrees
        assert torch.equal(x, x[:1].expand_as(x))
    t_slot, idx = best[0], bidx[0]
    meta_slot = torch.where(t_slot < INF, attrs[SP.META_ROW][idx], 0.0)
    assert torch.equal(torch.bincount(ray[live], minlength=n),
                       torch.ones(n, dtype=torch.long))  # each ray once
    t = torch.empty(n)
    meta = torch.empty(n)
    t[ray[live]] = t_slot[live]
    meta[ray[live]] = meta_slot[live]
    return t.reshape(shape), meta.reshape(shape)


@pytest.fixture(scope="module")
def cases():
    out = {"spike": SP.make_inputs(8, seed=0, device="cpu"),
           "ties": SP.make_tie_inputs(8, device="cpu"),
           "edge": SP.make_edge_inputs(device="cpu")}
    return {name: (args, SP.spike_pmat_plain(*args))
            for name, args in out.items()}


@pytest.mark.parametrize("k", SP.SPLITS)
@pytest.mark.parametrize("case", ["spike", "ties", "edge"])
def test_mirror_equals_the_plain_version(cases, case, k):
    args, (pt, pm) = cases[case]
    t, meta = mirror(*args, k=k)
    assert torch.equal(t.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(meta, pm)


def test_the_cases_hold_what_they_claim(cases):
    (tab, attrs, *planes), (t, meta) = cases["spike"]
    hit = torch.isfinite(t)
    assert 0.3 < hit.float().mean() < 0.8
    # ties: nearly every ray hits one of the four spheres, each of which
    # has 128 copies; the lowest copy wins
    _, (t, meta) = cases["ties"]
    hit = torch.isfinite(t)
    assert hit.float().mean() > 0.95 and (meta[hit] < 4).all()
    assert (meta[hit].unique().numel() == 4)
    (tab, attrs, *planes), (t, meta) = cases["edge"]
    key, disc = SP._keys(tab, *[p.reshape(1, -1) for p in planes])
    has = disc > 0.0
    ox, oy, oz, _, _, _, tm = planes
    assert planes[0].numel() % SP.BLOCK != 0
    # d = 0: no pair has disc > 0, no key, meta 0
    assert not has[:, 0::5].any()
    assert torch.isinf(t[0::5]).all() and (meta[0::5] == 0).all()
    # an origin at the centre of sphere 11: b = 0, so k1 = -sqrt(disc) is
    # below the threshold and the key is k2 = sqrt(disc) > 0
    c0, dc, t0, idt = tab[11, 0:3], tab[11, 3:6], tab[11, 6], tab[11, 7]
    kmov = (tm[1::5] - t0) * idt
    oc = [o[1::5] - (c0[q] + kmov * dc[q]) for q, o in enumerate((ox, oy,
                                                                 oz))]
    assert all((x == 0).all() for x in oc)
    assert has[11, 1::5].all() and (key[11, 1::5] > 0).all()
    # tangent to sphere 7: disc is exactly 0, so no hit there
    assert (disc[7, 2::5] == 0).all() and torch.isinf(key[7, 2::5]).all()
