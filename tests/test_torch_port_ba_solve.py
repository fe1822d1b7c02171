"""K9's conjugate-gradient solve (csrc/ba_normal.cu, entry 3) on the CPU:
a torch mirror of its arithmetic against jax.scipy.sparse.linalg.cg.

The kernel runs on the card only; this file holds what its design rests
on. `Layout`, the cameras' ranges and the point CSR that `bundle_adjust`
builds once, against numpy. `mirror_solve`, the kernel's iteration in
torch: x0 = 0, r0 = b, q_k = r + beta q_{k-1}, the product in its gather
form (each observation's point terms summed over the point CSR in order,
a camera's 6 sums over its runs, a run being a camera's observations in
one 32-observation tile, the focal scale's over the blocks' ranges), each
dot a leaf (rvecs, tvecs, points, dlog_f) summed over the blocks that own
its entries, then over the blocks in order, then the leaves in order,
and the stopping test read at the head of each iteration. It is held
against JAX's `cg` delta and `_lm_step` candidate within 1e-4 by relative
norm (tests/test_torch_port_mapping_ba's tolerance; for the delta of 50
ill-conditioned iterations, 4x JAX's own one-ulp spread where that is
wider: tests/test_torch_port_mapping_sfm's bar for the SfM's chaos), and
stops after as many iterations as the port's `cg`.
"""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu.mapping import ba as jba
from autolabel_tpu_torch.mapping import ba
from autolabel_tpu_torch.ops import ba_cuda
from tests.test_torch_port_mapping_ba import (_both, _flat, _jax_cg,
                                              _problem, _rel)

THREADS, WARPS, TILE = ba_cuda.SOLVE_THREADS, ba_cuda.SOLVE_THREADS // 32, 32


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sorted(prob):
    """The problem with its observations in camera order (bundle_adjust's
    on the card)."""
    rvecs, tvecs, points, intr, ci, pi, xy = prob
    o = np.argsort(ci, kind='stable')
    return rvecs, tvecs, points, intr, ci[o], pi[o], xy[o]


def _leaf_ids(m, p):
    L = ba.size(m, p)
    i = torch.arange(L)
    return torch.where(i < 3 * m, 0, torch.where(
        i < 6 * m, 1, torch.where(i < L - 1, 2, 3)))


def _owners(m, p, grid):
    """The thread that adds each entry's term into its dot: in the vector
    passes thread i % (grid x THREADS) owns entry i; in the gather thread
    t % (grid x THREADS) owns the points' entry 6 M + t, lane 0 of a warp
    a camera's 6 entries and lane 0 of the grid's last warp the focal
    scale."""
    L, threads = ba.size(m, p), grid * THREADS
    vector = torch.arange(L) % threads
    gather = torch.empty(L, dtype=torch.long)
    cam_thread = (torch.arange(m) % (grid * WARPS)) * 32
    gather[:3 * m] = cam_thread.repeat_interleave(3)
    gather[3 * m:6 * m] = cam_thread.repeat_interleave(3)
    gather[6 * m:6 * m + 3 * p] = torch.arange(3 * p) % threads
    gather[-1] = (grid * WARPS - 1) * 32
    return vector, gather


def _tree(v):
    """A warp's shfl_down tree over its last axis (32 lanes): lane 0's
    value."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def _dot(x, y, thread, leaves, grid):
    """_vdot_tree as the kernel sums it: each thread's terms of a leaf in
    entry order (an fma each), a block's threads by its warps' trees and
    the warps' tree, the blocks likewise (thread b holds block b's sums),
    then the leaves in order."""
    acc = torch.zeros((grid * THREADS, 4), dtype=torch.float64)
    terms = x.double() * y.double()
    order = torch.argsort(thread, stable=True)
    ranked = thread[order]
    first = torch.searchsorted(ranked, ranked, side='left')
    rank = torch.empty_like(thread)
    rank[order] = torch.arange(len(thread)) - first
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        acc[thread[sel], leaves[sel]] = (
            acc[thread[sel], leaves[sel]] + terms[sel]).float().double()
    acc = acc.float().view(grid, WARPS, 32, 4).transpose(2, 3)
    warps = _tree(acc)  # (grid, WARPS, 4)
    lanes = torch.zeros((grid, 4, 32), dtype=torch.float32)
    lanes[:, :, :WARPS] = warps.transpose(1, 2)
    blocks = torch.zeros((THREADS, 4), dtype=torch.float32)
    blocks[:grid] = _tree(lanes)  # thread b holds block b's sums
    warps = _tree(blocks.view(WARPS, 32, 4).transpose(1, 2))  # (WARPS, 4)
    lanes = torch.zeros((4, 32), dtype=torch.float32)
    lanes[:, :WARPS] = warps.t()
    total = torch.zeros((), dtype=torch.float32)
    for leaf_sum in _tree(lanes):
        total = total + leaf_sum
    return total


def _camera_runs(cam_start, c):
    """The observations at which camera c's runs end, as the kernel reads
    them: every n = 31 (mod 32) inside [cs, ce - 1), then ce - 1."""
    cs, ce = int(cam_start[c]), int(cam_start[c + 1])
    if ce <= cs:
        return []
    return list(range(cs | 31, ce - 1, TILE)) + [ce - 1]


class _GatherProduct:
    """J^T W J q + lam q, masked, in the kernel's gather form, from
    AnalyticProducts' linearisation."""

    def __init__(self, prod, layout, grid):
        self.prod, self.layout, self.grid = prod, layout, grid
        self.n = prod.sw.shape[0]
        tiles = -(-self.n // TILE)
        per = -(-tiles // grid)
        self.tile_block = torch.arange(self.n) // TILE // per
        cam = prod.lin['cam']
        # a run: one camera's observations in one tile
        key = torch.where(cam > 0, cam, -1)
        tile = torch.arange(self.n) // TILE
        head = torch.ones(self.n, dtype=torch.bool)
        head[1:] = (key[1:] != key[:-1]) | (tile[1:] != tile[:-1])
        self.run = torch.cumsum(head.long(), 0) - 1
        self.run_end = torch.zeros(int(self.run[-1]) + 1, dtype=torch.long)
        self.run_end[self.run] = torch.arange(self.n)  # the last wins

    def __call__(self, q, lam):
        prod, lin, m, p = self.prod, self.prod.lin, self.prod.m, self.prod.p
        refine = prod.refine_focal
        vr, vt, vp, vf = ba.unflatten(q, m, p)
        cam, pt = lin['cam'], lin['pt']
        d = (lin['Rc'] * vp[pt][:, None, :]).sum(-1) \
            + torch.where(lin['live'][:, None],
                          (lin['A'] * vr[cam][:, :, None]).sum(1) + vt[cam],
                          0.0)
        j0 = lin['fx'] * (d[:, 0] - lin['u'] * lin['dz'] * d[:, 2]) \
            / lin['z']
        j1 = lin['fy'] * (d[:, 1] - lin['v'] * lin['dz'] * d[:, 2]) \
            / lin['z']
        if refine:
            j0 = j0 + lin['u'] * lin['fx'] * vf
            j1 = j1 + lin['v'] * lin['fy'] * vf
        sw = prod.sw
        e0, e1 = sw * (sw * j0), sw * (sw * j1)
        gx0 = lin['fx'] * e0 / lin['z']
        gx1 = lin['fy'] * e1 / lin['z']
        gx2 = -(gx0 * lin['u'] + gx1 * lin['v']) * lin['dz']
        gx = torch.stack([gx0, gx1, gx2], dim=-1)
        pt_terms = (lin['Rc'] * gx[:, :, None]).sum(1)
        cam_terms = torch.cat([(lin['A'] * gx[:, None, :]).sum(-1), gx], 1)
        out = torch.zeros_like(q)
        o_r, o_t, o_p, _ = ba.unflatten(out, m, p)
        # points: each over its observations in CSR order
        order = self.layout.pt_obs.long()
        o_p.index_add_(0, pt[order], pt_terms[order])
        # cameras: each run's sums, then a camera's runs in order
        runs = torch.zeros((len(self.run_end), 6), dtype=torch.float32)
        runs.index_add_(0, self.run, cam_terms)
        for c in range(1, m):
            ends = _camera_runs(self.layout.cam_start, c)
            if ends:
                total = runs[self.run[ends]].sum(0)
                o_r[c], o_t[c] = total[:3], total[3:]
        if refine:
            focal = e0 * lin['u'] * lin['fx'] + e1 * lin['v'] * lin['fy']
            part = torch.zeros(self.grid, dtype=torch.float32)
            part.index_add_(0, self.tile_block, focal)
            out[-1] = part.sum()
        mask = ba.gauge_mask(m, p, refine, q.device)
        return (out + np.float32(lam) * q) * mask


def mirror_solve(prod, b, lam, maxiter, tol=ba.CG_TOL, grid=4):
    """K9's solve in torch: (x, k)."""
    m, p = prod.m, prod.p
    layout = ba_cuda.Layout(prod.lin['cam'].int(), prod.lin['pt'].int(),
                            m, p)
    product = _GatherProduct(prod, layout, grid)
    leaves = _leaf_ids(m, p)
    vector, gather = _owners(m, p, grid)
    tol2 = np.float32(tol) * np.float32(tol)
    x, r, q = torch.zeros_like(b), b.clone(), b.clone()
    rr = _dot(r, r, vector, leaves, grid)
    gamma, atol2, k = None, None, 0
    while True:
        if k == 0:
            atol2 = tol2 * rr
        else:
            q = r + (rr / gamma) * q
        gamma = rr
        if k >= maxiter or not bool(gamma > atol2):
            return x, k
        Aq = product(q, lam)
        alpha = gamma / _dot(q, Aq, gather, leaves, grid)
        x = x + alpha * q
        r = r - alpha * Aq
        rr = _dot(r, r, vector, leaves, grid)
        k += 1


def _shifted(seed):
    prob = _sorted(_problem('ring', seed=seed))
    return (prob[0] + 0.01, prob[1] - 0.02, prob[2] * 1.01) + prob[3:]


@functools.cache
def _jax_spread(seed, lam, maxiter):
    """JAX's own spread on `_shifted(seed)`: the largest relative move of
    jax.scipy's delta when the linearisation point's rvecs, tvecs or
    points move by one ulp, up or down (the chaos bar of
    tests/test_torch_port_mapping_sfm)."""
    prob = _shifted(seed)
    (jp, jc), _ = _both(prob, np.ones(len(prob[4]), np.float32))
    want = _jax_cg(jp, jc, lam, False, maxiter)
    spread = 0.0
    for leaf in range(3):
        for toward in (np.inf, -np.inf):
            nudged = list(jp)
            nudged[leaf] = jnp.asarray(np.nextafter(
                np.asarray(jp[leaf], np.float32), np.float32(toward)))
            spread = max(spread, _rel(_jax_cg(tuple(nudged), jc, lam, False,
                                              maxiter), want))
    return spread


@pytest.mark.parametrize('grid', [3, 132])
@pytest.mark.parametrize('lam,maxiter', [(1e-2, 50), (1e7, 50), (1e-2, 7)])
def test_mirror_solve_matches_jax_cg(lam, maxiter, grid):
    """The mirror's delta within 1e-4 of jax.scipy's by relative norm, or
    within 4x JAX's own spread where that is wider (at lam = 1e-2, 50 fp32
    iterations on this ill-conditioned system move JAX's delta by up to
    1.2e-4 when one leaf of the linearisation point moves by one ulp:
    another order of the sums lands anywhere in such a spread); its k the
    port's `cg`'s (the loop that stops); lam = 1e7 stops early."""
    prob = _shifted(11)
    sw = np.ones(len(prob[4]), np.float32)
    (jp, jc), (tp, tc) = _both(prob, sw)
    want = _jax_cg(jp, jc, lam, False, maxiter)
    prod = ba.AnalyticProducts(tp, tc, False)
    g = prod.residual_grad()[2]
    got, k = mirror_solve(prod, -g, lam, maxiter, grid=grid)
    _, k_cg = ba.cg(lambda v: prod.matvec(v, lam), -g, 6, 120, maxiter)
    err = _rel(got.numpy(), want)
    assert err <= 1e-4 or err <= 4 * _jax_spread(11, lam, maxiter), err
    assert k == k_cg
    assert (k < maxiter) == (lam == 1e7)


@pytest.mark.parametrize('refine_focal', [False, True])
def test_mirror_lm_step_matches_jax(refine_focal):
    """One LM step through the mirror on the hard problem (the depth
    clamp, a tie, theta = 0, outliers) under JAX's Huber weights: the
    candidate within 1e-4 of JAX's `_lm_step`'s by relative norm, the
    delta within 1e-3, k the port's `cg`'s."""
    prob = _sorted(_problem('hard', seed=12))
    (jp, jc), _ = _both(prob, np.ones(len(prob[4]), np.float32))
    sw = np.asarray(jba._huber_sqrt_weights(jp, jc, 4.0))
    (jp, jc), (tp, tc) = _both(prob, sw)
    jcand, _ = jba._lm_step(jp, jc, 1e-2, refine_focal, 50)
    prod = ba.AnalyticProducts(tp, tc, refine_focal)
    g = prod.residual_grad()[2]
    delta, k = mirror_solve(prod, -g, 1e-2, 50)
    _, k_cg = prod.cg_solve(-g, 1e-2, 50)
    delta = ba._mask_gauge(ba.unflatten(delta, 6, 120), refine_focal)
    cand = [a + d for a, d in zip(tp, delta)]
    want, got = _flat(jcand), _flat([c.numpy() for c in cand])
    assert _rel(got, want) <= 1e-4
    assert _rel(got - _flat(jp), want - _flat(jp)) <= 1e-3
    assert k == k_cg and 0 < k <= 50


@pytest.mark.parametrize('refine_focal', [False, True])
@pytest.mark.parametrize('grid', [1, 5, 132])
def test_gather_product_equals_the_scatter(refine_focal, grid):
    """The product in the kernel's gather form (points over the CSR,
    cameras over their runs, the focal over the blocks) equals
    AnalyticProducts' index_add_ scatter within fp32 rounding."""
    prob = _sorted(_problem('hard', seed=4))
    sw = np.random.default_rng(5).uniform(0.2, 1.0, len(prob[4])) \
        .astype(np.float32)
    _, (tp, tc) = _both(prob, sw)
    prod = ba.AnalyticProducts(tp, tc, refine_focal)
    layout = ba_cuda.Layout(tc[1], tc[2], 6, 120)
    v = torch.randn(ba.size(6, 120), generator=torch.Generator()
                    .manual_seed(6))
    got = _GatherProduct(prod, layout, grid)(v, 0.3)
    want = prod.matvec(v, 0.3)
    assert _rel(got.numpy(), want.numpy()) <= 1e-6


@pytest.mark.parametrize('kind', ['ring', 'hard'])
def test_layout_holds_the_camera_ranges_and_the_point_csr(kind):
    """cam_start[c] is camera c's first observation (cameras without one
    included), pt_start / pt_obs each point's observations in ascending
    order, all int32."""
    prob = _sorted(_problem(kind, seed=7))
    ci, pi = prob[4], prob[5]
    # a point and a camera seen by nobody
    keep = (pi != 5) & (ci != 3)
    ci, pi = ci[keep], pi[keep]
    lay = ba_cuda.Layout(torch.tensor(ci, dtype=torch.int32),
                         torch.tensor(pi, dtype=torch.int32), 6, 120)
    for t in (lay.cam_start, lay.pt_start, lay.pt_obs):
        assert t.dtype == torch.int32
    np.testing.assert_array_equal(
        lay.cam_start.numpy(), np.searchsorted(ci, np.arange(7)))
    assert lay.pt_start[0] == 0 and lay.pt_start[-1] == len(pi)
    for p in (0, 5, 17, 119):
        got = lay.pt_obs[lay.pt_start[p]:lay.pt_start[p + 1]].numpy()
        np.testing.assert_array_equal(got, np.nonzero(pi == p)[0])


def test_layout_refuses_observations_out_of_camera_order():
    prob = _problem('ring', seed=0)
    ci = np.asarray(prob[4])[::-1].copy()
    with pytest.raises(ValueError, match='camera order'):
        ba_cuda.Layout(torch.tensor(ci, dtype=torch.int32),
                       torch.tensor(prob[5], dtype=torch.int32), 6, 120)


@pytest.mark.parametrize('start,stop', [(0, 1), (0, 32), (5, 40), (31, 33),
                                        (32, 64), (7, 300), (100, 100)])
def test_camera_runs_partition_the_camera(start, stop):
    """The run ends the kernel reads for a camera over [start, stop): one
    a 32-observation tile the camera touches, each the camera's last
    observation in that tile."""
    cam_start = torch.tensor([start, stop])
    ends = _camera_runs(cam_start, 0)
    tiles = sorted({n // TILE for n in range(start, stop)})
    assert len(ends) == len(tiles)
    for n, t in zip(ends, tiles):
        assert n == min(t * TILE + TILE - 1, stop - 1) and n // TILE == t


def test_solve_constants_match_the_source():
    src = open(os.path.join(os.path.dirname(ba_cuda.__file__), '..', 'csrc',
                            'ba_normal.cu')).read()
    assert f'#define SOLVE_THREADS {ba_cuda.SOLVE_THREADS}' in src
    # KernelProducts.solve_product reads Aq as the L floats before the
    # workspace's last 9 N (obs_pt, 3 N, then obs_cam, 6 N)
    assert '// work: 9 grid + 4 L + 9 N floats' in src
    assert 's.obs_pt = s.Aq + L; s.obs_cam = s.obs_pt + 3 * N;' in src



def test_solve_part_cuts_apply_to_the_source():
    """kernel_compare.py times the solve's parts from copies of the source
    cut by `-DK9_SOLVE_PART`: each cut finds its text once, and each part
    keeps what its name says (the shipped kernel has no switch)."""
    import kernel_compare
    src = open(os.path.join(os.path.dirname(ba_cuda.__file__), '..', 'csrc',
                            'ba_normal.cu')).read()
    assert 'K9_SOLVE_PART' not in src
    endifs = src.count('#endif')
    for old, new in kernel_compare._K9_SOLVE_CUTS:
        assert src.count(old) == 1, old
        assert old.split('\n')[0] in new
        src = src.replace(old, new)
    assert sorted(kernel_compare.K9_SOLVE_PARTS) == [1, 2, 3, 4]
    assert src.count('#if K9_SOLVE_PART') == src.count('#endif') - endifs
