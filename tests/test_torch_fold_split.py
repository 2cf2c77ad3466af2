"""The bounce kernel's split sphere fold, mirrored in PyTorch, against the
sequential fold of the plain version (`bounce_core.sphere_fold`), bit for
bit.  No JAX.

The kernel (`ops/csrc/wave_bounce.cu`: fold_share, reduce_split) folds one
lane with K threads: thread `sub` takes spheres start+sub, start+sub+K, ...
of each media segment's static run and of its moving run, reading the
16-byte records of `wave_bounce.fold_table`; the K partial (key, index)
pairs are then reduced by a shuffle butterfly in lexicographic order and
the per-segment keys by their minimum.  `split_fold` below does the same
with the K threads as a leading tensor dimension; every float op is the
kernel's, so the result must equal the sequential fold exactly, for every
K, on the final scene's probe rays, on a scene full of equal keys with
spheres on both sides of two media (`probe.tie_scene`), and on rays with
d = 0.
"""
import numpy as np
import pytest
import torch

from path_tracer_tpu_torch.core.vec import fsqrt
from path_tracer_tpu_torch.engine.wq import _pack_atlas_flat
from path_tracer_tpu_torch.ops import bounce_core, probe
from path_tracer_tpu_torch.ops import wave_bounce as WB
from path_tracer_tpu_torch.scene.presets import build_final_scene

W, H = 160, 120
INF = float("inf")


def split_fold(fold, sph_segs, k, ox, oy, oz, dx, dy, dz, tm, a, tmin_a):
    """The kernel's split fold: (key, index, snapshots) per lane."""
    n = a.shape[0]
    sub = torch.arange(k)
    bk = torch.full((k, n), INF)
    bidx = torch.zeros((k, n), dtype=torch.long)
    snap = []
    row = lambda v: v[None, :]
    col = lambda v: v[:, None]
    start = moved = 0
    for m, (static_end, end) in enumerate(sph_segs):
        for lo, hi, moving in ((start, static_end, False),
                               (static_end, end, True)):
            for j0 in range(lo, hi, k):
                j = j0 + sub                       # one sphere a thread
                live = col(j < hi)
                jc = torch.clamp(j, max=hi - 1)
                if moving:
                    rec = 3 * jc + 2 * (moved - static_end)
                    c, v, q = fold[rec], fold[rec + 1], fold[rec + 2]
                    kmov = (row(tm) - col(v[:, 3])) * col(q[:, 0])
                    cox = (col(c[:, 0]) + kmov * col(v[:, 0])) - row(ox)
                    coy = (col(c[:, 1]) + kmov * col(v[:, 1])) - row(oy)
                    coz = (col(c[:, 2]) + kmov * col(v[:, 2])) - row(oz)
                else:
                    c = fold[jc + 2 * moved]
                    cox = col(c[:, 0]) - row(ox)
                    coy = col(c[:, 1]) - row(oy)
                    coz = col(c[:, 2]) - row(oz)
                nb = cox * row(dx) + coy * row(dy) + coz * row(dz)
                cc = cox * cox + coy * coy + coz * coz - col(c[:, 3])
                disc = nb * nb - row(a) * cc
                sq = fsqrt(disc)
                k1, k2 = nb - sq, nb + sq
                cand = torch.where(k1 > row(tmin_a), k1, k2)
                take = (live & (disc > 0.0) & (cand > row(tmin_a))
                        & (cand < bk))
                bk = torch.where(take, cand, bk)
                bidx = torch.where(take, col(j), bidx)
        moved += end - static_end
        if m < len(sph_segs) - 1:
            snap.append(bk)
        start = end
    off = 1
    while off < k:                                 # the shuffle butterfly
        o = sub ^ off
        ok, oi = bk[o], bidx[o]
        take = (ok < bk) | ((ok == bk) & (oi < bidx))
        bk, bidx = torch.where(take, ok, bk), torch.where(take, oi, bidx)
        snap = [torch.minimum(s, s[o]) for s in snap]
        off *= 2
    for t in (bk, bidx, *snap):                    # every thread agrees
        assert torch.equal(t, t[:1].expand_as(t))
    return bk[0], bidx[0], [s[0] for s in snap]


def _rays(scene, cam, rows, seed, zero_d):
    tables = WB.pack_scene(scene, "cpu")._replace(
        cam=WB.pack_camera(cam, W, H, "cpu"), seed=seed)
    atlas, _ = _pack_atlas_flat(scene.textures.atlas)
    st, _, _, _ = probe.probe_state(tables, cam, W, H, atlas, rows=rows,
                                    bounces=2, max_depth=4, seed=seed,
                                    tile_rows=1)
    ray = [st.ox, st.oy, st.oz, st.dx, st.dy, st.dz, st.tm]
    ray = [v.reshape(-1) for v in ray]
    if zero_d:                                     # every 5th lane: d = 0
        for i in (3, 4, 5):
            ray[i] = ray[i].clone()
            ray[i][::5] = 0.0
    return tables, ray


@pytest.fixture(scope="module")
def cases():
    final = build_final_scene(W / H, device="cpu")
    ties = probe.tie_scene(W / H, device="cpu")
    return {"final": _rays(*final, rows=1, seed=3, zero_d=False),
            "ties": _rays(*ties, rows=2, seed=4, zero_d=False),
            "final_zero_d": _rays(*final, rows=1, seed=5, zero_d=True)}


@pytest.mark.parametrize("k", WB.SPLITS)
@pytest.mark.parametrize("case", ["final", "ties", "final_zero_d"])
def test_split_fold_equals_the_sequential_fold(cases, case, k):
    tables, (ox, oy, oz, dx, dy, dz, tm) = cases[case]
    a = dx * dx + dy * dy + dz * dz
    tmin_a = np.float32(1e-3) * a
    segs = tables.sph_segs.tolist()
    bk, bidx, snap = bounce_core.sphere_fold(tables.sph, segs, ox, oy, oz,
                                             dx, dy, dz, tm, a, tmin_a)
    sk, sidx, ssnap = split_fold(tables.fold, segs, k, ox, oy, oz, dx, dy,
                                 dz, tm, a, tmin_a)
    bits = lambda t: t.view(torch.int32)
    assert torch.equal(bits(sk), bits(bk))
    assert torch.equal(sidx, bidx.long())
    assert len(ssnap) == len(snap) == tables.med.shape[1]
    for s, t in zip(ssnap, snap):
        assert torch.equal(bits(s), bits(t))
    hit = torch.isfinite(bk)
    assert hit.float().mean() > 0.3, "too few lanes hit a sphere"
    if case == "ties":   # the tie rule is exercised: a copy lost to its twin
        sph = tables.sph[:, bidx.long()[hit]]
        copies = (tables.sph[None, [0, 1, 2, 8], :]
                  == sph[[0, 1, 2, 8]].T[:, :, None]).all(1).sum(1)
        assert (copies > 1).float().mean() > 0.1
    if case == "final_zero_d":
        assert not hit[::5].any() and torch.equal(bidx[::5],
                                                  torch.zeros_like(bidx[::5]))


@pytest.mark.parametrize("name", ["final", "ties"])
def test_fold_table_holds_the_sphere_rows(cases, name):
    tables = cases[name][0]
    sph, fold = tables.sph, tables.fold
    recs, start = [], 0
    for static_end, end in tables.sph_segs.tolist():
        for j in range(start, end):
            recs.append(sph[[0, 1, 2, 8], j])
            if j >= static_end:            # moving: motion, t0, 1/dt
                recs.append(sph[[3, 4, 5, 6], j])
                recs.append(torch.stack([sph[7, j], *torch.zeros(3)]))
        start = end
    assert fold.dtype == torch.float32 and fold.is_contiguous()
    assert torch.equal(fold, torch.stack(recs))
