"""Incremental structure-from-motion on cv2 feature geometry.

Counterpart of autolabel_tpu/mapping/sfm.py: SIFT/ORB features or KLT
tracks, ratio-test matching over a sliding frame window, essential-matrix
initialization, PnP registration, linear triangulation, and periodic
bundle adjustment (mapping/ba.py, K9 on the card). The output is a
COLMAP-convention model (world->camera poses + tracks) written with
utils.colmap_text for the mapping CLI's ScaleEstimation / PoseSaver.

cv2 is imported inside the front end only (`_cv2`): feature extraction,
matching, tracking, initialization, triangulation and PnP raise
utils.MissingDependency (an ImportError) naming cv2 without it. The constructor and the stages that
need no cv2 (`_observations`, `_run_ba`, `_prune_outliers`,
`_drop_pose_outliers`, `_drop_tear_frames`, `write_colmap_model`) run
without it, on the card: `cv2.Rodrigues(R)` is `ba.rotmat_to_rvec`.

Scope: a single shared pinhole camera, zero distortion (scanner/phone
captures in this pipeline are already undistorted or nearly so); the
hloc backend remains the choice for uncontrolled captures.
"""
import numpy as np
import torch

from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.mapping.ba import (bundle_adjust, rodrigues,
                                            rotmat_to_rvec)
from autolabel_tpu_torch.utils import require
from autolabel_tpu_torch.utils.colmap_text import (ColmapCamera, ColmapImage,
                                                   ColmapPoint2D,
                                                   ColmapPoint3D,
                                                   rotmat_to_qvec,
                                                   write_text_model)


def _cv2():
    """cv2, imported at the call: the front end's one dependency."""
    return require('cv2', 'the SfM front end (feature tracking, matching, '
                   'initialization, triangulation, PnP)')


class _UnionFind:
    """Union-find over (frame, keypoint) with frame-conflict refusal: a
    merge that would place two keypoints of one frame in a single track
    is skipped (the COLMAP track-builder rule) — with repetitive texture
    a handful of wrong matches would otherwise fuse and destroy whole
    tracks."""

    def __init__(self):
        self.parent = {}
        self.frames = {}  # root -> set of frames in the component

    def find(self, a):
        if a not in self.parent:
            self.parent[a] = a
            self.frames[a] = {a[0]}
        root = a
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[a] != root:  # path compression
            self.parent[a], a = root, self.parent[a]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        fa, fb = self.frames[ra], self.frames[rb]
        if fa & fb:
            return  # frame conflict: keep the tracks separate
        if len(fa) < len(fb):
            ra, rb, fa, fb = rb, ra, fb, fa
        self.parent[rb] = ra
        fa |= fb
        del self.frames[rb]


def _make_detector(kind):
    cv2 = _cv2()
    if kind == 'sift' and hasattr(cv2, 'SIFT_create'):
        # Low contrast threshold: repetitive indoor texture needs a
        # dense keypoint pool for the ratio test + RANSAC to sieve.
        return (cv2.SIFT_create(nfeatures=6000, contrastThreshold=0.006,
                                edgeThreshold=20), cv2.NORM_L2)
    return cv2.ORB_create(nfeatures=6000), cv2.NORM_HAMMING


class IncrementalSfM:
    """images: list of (name, grayscale uint8) in capture order."""

    def __init__(self, images, K, window=6, detector='klt',
                 ratio=0.85, min_pair_inliers=15, seed=0, device=None):
        self.device = resolve_device(device)
        self.names = [n for n, _ in images]
        self.images = [im for _, im in images]
        self.K = np.asarray(K, np.float64)
        self.window = window
        self.ratio = ratio
        self.min_pair_inliers = min_pair_inliers
        self.rng = np.random.default_rng(seed)
        self.detector_kind = detector

        n = len(self.images)
        # Per-frame state. Poses are world->camera (R, t), COLMAP-style.
        self.kps = [None] * n
        self.desc = [None] * n
        self.registered = {}
        self.failed = set()
        # track id -> {frame: kp_idx}; point id == track id once
        # triangulated (xyz in self.points).
        self.tracks = {}
        self.points = {}
        self.track_of_kp = {}

    # ---------------------------------------------------------- features
    def _extract(self):
        # The detector is made here, not in the constructor, so that the
        # constructor needs no cv2.
        self.detector, self.norm = _make_detector(self.detector_kind)
        for i, im in enumerate(self.images):
            kps, desc = self.detector.detectAndCompute(im, None)
            self.kps[i] = np.array([k.pt for k in kps], np.float64).reshape(
                -1, 2)
            self.desc[i] = desc

    def _match_pair(self, i, j):
        cv2 = _cv2()
        if self.desc[i] is None or self.desc[j] is None:
            return np.zeros((0, 2), int)
        if len(self.kps[i]) < 8 or len(self.kps[j]) < 8:
            return np.zeros((0, 2), int)
        matcher = cv2.BFMatcher(self.norm)
        raw = matcher.knnMatch(self.desc[i], self.desc[j], k=2)
        good = [m for m, s in (p for p in raw if len(p) == 2)
                if m.distance < self.ratio * s.distance]
        if len(good) < self.min_pair_inliers:
            return np.zeros((0, 2), int)
        pts_i = self.kps[i][[m.queryIdx for m in good]]
        pts_j = self.kps[j][[m.trainIdx for m in good]]
        # Geometric verification: essential-matrix RANSAC.
        _, inl = cv2.findEssentialMat(pts_i, pts_j, self.K,
                                      method=cv2.RANSAC, prob=0.999,
                                      threshold=1.5)
        if inl is None:
            return np.zeros((0, 2), int)
        keep = inl.ravel().astype(bool)
        return np.array([(good[k].queryIdx, good[k].trainIdx)
                         for k in np.nonzero(keep)[0]], int).reshape(-1, 2)

    def _build_tracks_klt(self):
        """KLT front-end for video-like captures: Shi-Tomasi corners
        tracked frame to frame with pyramidal Lucas-Kanade (forward +
        backward check), replenished as tracks die. Subpixel track
        positions (~0.1 px on clean video vs ~1 px descriptor keypoints)
        are what bound the downstream pose accuracy."""
        cv2 = _cv2()
        n = len(self.images)
        lk = dict(winSize=(21, 21), maxLevel=3,
                  criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                            30, 0.01))
        kps = [[] for _ in range(n)]
        tracks = {}
        tid = 0
        active = {}  # tid -> current position

        def replenish(i, mask_pts):
            nonlocal tid
            mask = np.full(self.images[i].shape[:2], 255, np.uint8)
            for x, y in mask_pts:
                cv2.circle(mask, (int(x), int(y)), 9, 0, -1)
            corners = cv2.goodFeaturesToTrack(
                self.images[i], maxCorners=1500, qualityLevel=0.01,
                minDistance=8, mask=mask)
            if corners is None:
                return
            for pt in corners.reshape(-1, 2):
                kp = len(kps[i])
                kps[i].append(pt)
                tracks[tid] = {i: kp}
                active[tid] = pt
                tid += 1

        replenish(0, [])
        for i in range(1, n):
            if active:
                ids = sorted(active)
                prev = np.array([active[t] for t in ids],
                                np.float32).reshape(-1, 1, 2)
                nxt, st, _ = cv2.calcOpticalFlowPyrLK(
                    self.images[i - 1], self.images[i], prev, None, **lk)
                back, st2, _ = cv2.calcOpticalFlowPyrLK(
                    self.images[i], self.images[i - 1], nxt, None, **lk)
                fb = np.linalg.norm(prev - back, axis=-1).ravel()
                ok = (st.ravel() == 1) & (st2.ravel() == 1) & (fb < 0.5)
                h, w = self.images[i].shape[:2]
                pts = nxt.reshape(-1, 2)
                ok &= ((pts[:, 0] >= 0) & (pts[:, 0] < w)
                       & (pts[:, 1] >= 0) & (pts[:, 1] < h))
                for t, pt, good in zip(ids, pts, ok):
                    if good:
                        kp = len(kps[i])
                        kps[i].append(pt)
                        tracks[t][i] = kp
                        active[t] = pt
                    else:
                        del active[t]
            replenish(i, list(active.values()))

        self.kps = [np.array(k, np.float64).reshape(-1, 2) for k in kps]
        self.tracks = {t: fr for t, fr in tracks.items() if len(fr) >= 2}
        self.track_of_kp = {(f, kp): t
                            for t, fr in self.tracks.items()
                            for f, kp in fr.items()}
        self._tid = tid
        self._add_wide_baseline_tracks()
        # Synthesize windowed pair matches from track co-visibility and
        # verify them geometrically, mirroring the descriptor path.
        self.pair_matches = {}
        for i in range(n):
            for j in range(i + 1, min(i + 1 + self.window, n)):
                m = np.array([(fr[i], fr[j])
                              for fr in self.tracks.values()
                              if i in fr and j in fr], int).reshape(-1, 2)
                if len(m) < self.min_pair_inliers:
                    continue
                _, inl = cv2.findEssentialMat(
                    self.kps[i][m[:, 0]], self.kps[j][m[:, 1]], self.K,
                    method=cv2.RANSAC, prob=0.999, threshold=1.5)
                if inl is None:
                    continue
                m = m[inl.ravel().astype(bool)]
                if len(m) >= self.min_pair_inliers:
                    self.pair_matches[(i, j)] = m

    def _add_wide_baseline_tracks(self, stride=4, gaps=(8, 12, 16, 24),
                                  ratio=0.85):
        """Anti-drift pass for the KLT front-end: KLT tracks only chain
        CONSECUTIVE frames, so pose error accumulates along the capture.
        Descriptor matches between far-apart keyframes are appended as
        wide-baseline two-view tracks — long-range constraints that the
        bundle adjustment uses to pin the sequence ends together."""
        cv2 = _cv2()
        det, norm = _make_detector('sift')
        n = len(self.images)
        keyframes = list(range(0, n, stride))
        feats = {}
        for i in keyframes:
            kp, desc = det.detectAndCompute(self.images[i], None)
            if desc is not None and len(kp) >= 8:
                feats[i] = (np.array([k.pt for k in kp]), desc)
        matcher = cv2.BFMatcher(norm)
        for i in keyframes:
            if i not in feats:
                continue
            for gap in gaps:
                j = i + gap
                if j >= n or j not in feats:
                    continue
                (pts_i, d_i), (pts_j, d_j) = feats[i], feats[j]
                raw = matcher.knnMatch(d_i, d_j, k=2)
                good = [m for m, s in (p for p in raw if len(p) == 2)
                        if m.distance < ratio * s.distance]
                if len(good) < 8:
                    continue
                gi = pts_i[[m.queryIdx for m in good]]
                gj = pts_j[[m.trainIdx for m in good]]
                _, inl = cv2.findEssentialMat(gi, gj, self.K,
                                              method=cv2.RANSAC,
                                              prob=0.999, threshold=1.5)
                if inl is None:
                    continue
                for k in np.nonzero(inl.ravel())[0]:
                    self._stitch_match(i, gi[k], j, gj[k])

    def _nearest_track_kp(self, frame, pt, tol_px=2.0):
        if len(self.kps[frame]) == 0:
            return None
        d2 = ((self.kps[frame] - pt) ** 2).sum(1)
        k = int(np.argmin(d2))
        if d2[k] > tol_px ** 2:
            return None
        return self.track_of_kp.get((frame, k))

    def _stitch_match(self, i, pt_i, j, pt_j):
        """Fold one wide-baseline match into the track graph. When both
        endpoints coincide with existing KLT keypoints, their tracks are
        MERGED into one long track: the same physical point observed at
        both ends of the sequence, which is what actually pins scale
        drift (a fresh two-view track constrains almost nothing — its
        point has enough freedom to satisfy both views for any poses)."""
        ti = self._nearest_track_kp(i, pt_i)
        tj = self._nearest_track_kp(j, pt_j)
        if ti is not None and tj is not None:
            if ti == tj:
                return
            fi, fj = self.tracks[ti], self.tracks[tj]
            if set(fi) & set(fj):
                return  # frame conflict: refuse the merge
            for f, kp in fj.items():
                fi[f] = kp
                self.track_of_kp[(f, kp)] = ti
            del self.tracks[tj]
            self.points.pop(tj, None)
            self.points.pop(ti, None)  # re-triangulate the merged track
            return
        if ti is not None or tj is not None:
            # Extend the existing track with the new far observation.
            tid = ti if ti is not None else tj
            f, pt = (j, pt_j) if ti is not None else (i, pt_i)
            if f in self.tracks[tid]:
                return
            kp = len(self.kps[f])
            self.kps[f] = np.concatenate([self.kps[f], pt[None]], axis=0)
            self.tracks[tid][f] = kp
            self.track_of_kp[(f, kp)] = tid
            self.points.pop(tid, None)
            return
        ki, kj = len(self.kps[i]), len(self.kps[j])
        self.kps[i] = np.concatenate([self.kps[i], pt_i[None]], axis=0)
        self.kps[j] = np.concatenate([self.kps[j], pt_j[None]], axis=0)
        self.tracks[self._tid] = {i: ki, j: kj}
        self.track_of_kp[(i, ki)] = self._tid
        self.track_of_kp[(j, kj)] = self._tid
        self._tid += 1

    def _build_tracks(self):
        n = len(self.images)
        uf = _UnionFind()
        self.pair_matches = {}
        for i in range(n):
            for j in range(i + 1, min(i + 1 + self.window, n)):
                m = self._match_pair(i, j)
                if len(m) >= self.min_pair_inliers:
                    self.pair_matches[(i, j)] = m
                    for ki, kj in m:
                        uf.union((i, ki), (j, kj))
        # Collapse to tracks, dropping inconsistent ones (two keypoints
        # of the same frame in one track).
        groups = {}
        for key in uf.parent:
            groups.setdefault(uf.find(key), []).append(key)
        self.tracks = {}
        tid = 0
        for members in groups.values():
            if len(members) < 2:
                continue
            frames = [f for f, _ in members]
            if len(set(frames)) != len(frames):
                continue
            self.tracks[tid] = dict(members)
            for f, k in members:
                self.track_of_kp[(f, k)] = tid
            tid += 1

    # ------------------------------------------------------ registration
    def _init_pair(self, min_parallax_deg=3.0, max_h_ratio=0.85):
        """Initialization pair: enough verified matches, enough parallax,
        AND not homography-degenerate. A small-baseline pair makes the
        essential matrix pure noise and collapses the whole
        reconstruction into a rotation-only local minimum. The
        triangulation-angle gate alone is NOT sufficient: at a
        near-zero baseline the triangulated depths are noise-dominated
        and the measured angles are spuriously LARGE (adjacent video
        frames measure >3 deg median on ~1 deg true parallax), so a
        degenerate pair can win the scan and seed a torn, ghost-branch
        reconstruction. The homography test is the discriminator
        (ORB-SLAM's model selection / COLMAP's init gating): when one H
        explains nearly all verified matches the pair is either
        baseline-free or a pure plane — useless for initialization
        either way."""
        cv2 = _cv2()
        # Adjacent video frames are never useful init pairs: their true
        # parallax sits at the keypoint-noise floor, and on periodic
        # textures coherently aliased tracks can fabricate a
        # large-baseline geometry that passes every per-pair test
        # (measured on the checkered room fixture: adjacent pairs with
        # ~1 deg true parallax score 3-6 deg). Prefer pairs at least 3
        # frames apart; the close pairs remain as a last resort.
        scored = sorted(self.pair_matches.items(),
                        key=lambda kv: (kv[0][1] - kv[0][0] >= 3,
                                        len(kv[1])),
                        reverse=True)
        best = None

        def better(cand, incumbent):
            if incumbent is None:
                return True
            # Prefer non-degenerate, then widest parallax.
            return (not cand[5], cand[4]) > (not incumbent[5],
                                             incumbent[4])

        for (i, j), m in scored:
            pts_i = self.kps[i][m[:, 0]]
            pts_j = self.kps[j][m[:, 1]]
            E, inl = cv2.findEssentialMat(pts_i, pts_j, self.K,
                                          method=cv2.RANSAC, prob=0.999,
                                          threshold=1.5)
            if E is None:
                continue
            n_good, R, t, _ = cv2.recoverPose(E, pts_i, pts_j, self.K,
                                              mask=inl.copy())
            if n_good < self.min_pair_inliers:
                continue
            degenerate = False
            if len(m) >= 8:
                H, h_inl = cv2.findHomography(pts_i, pts_j, cv2.RANSAC,
                                              1.5)
                degenerate = (H is not None and h_inl is not None
                              and h_inl.sum() > max_h_ratio * len(m))
            # Median triangulation angle of the pair's inlier points at
            # the recovered (unit-baseline) geometry.
            P1 = self.K @ np.eye(3, 4)
            P2 = self.K @ np.concatenate([R, t.reshape(3, 1)], axis=1)
            X = cv2.triangulatePoints(P1, P2, pts_i.T, pts_j.T)
            X = (X[:3] / np.where(np.abs(X[3]) < 1e-12, 1e-12, X[3])).T
            c2 = (-R.T @ t).ravel()
            r1 = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True),
                                1e-12)
            d2 = X - c2
            r2 = d2 / np.maximum(np.linalg.norm(d2, axis=1, keepdims=True),
                                 1e-12)
            ang = np.degrees(np.arccos(np.clip((r1 * r2).sum(1), -1, 1)))
            parallax = float(np.median(ang))
            if parallax >= min_parallax_deg and not degenerate:
                best = (i, j, R, t, parallax, degenerate)
                break
            cand = (i, j, R, t, parallax, degenerate)
            if better(cand, best):
                best = cand  # fallback: non-degenerate, widest parallax
        if best is None:
            raise RuntimeError(
                'SfM initialization failed: no image pair with enough '
                'verified matches (is the capture textured?)')
        i, j, R, t, _, _ = best
        self.registered[i] = (np.eye(3), np.zeros(3))
        self.registered[j] = (R, t.ravel())
        self._triangulate_tracks(
            tid for tid in (self.track_of_kp.get((i, k))
                            for k in range(len(self.kps[i])))
            if tid is not None)
        return i, j

    def _proj(self, frame):
        R, t = self.registered[frame]
        return self.K @ np.concatenate([R, t.reshape(3, 1)], axis=1)

    def _center(self, frame):
        R, t = self.registered[frame]
        return -R.T @ t

    def _triangulate_tracks(self, tids):
        """Triangulate untriangulated tracks from their WIDEST-baseline
        pair of registered views (tracks outlive the matching window, so
        this uses far more parallax than windowed pair triangulation),
        gated on triangulation angle + reprojection consistency."""
        cv2 = _cv2()
        for tid in tids:
            if tid in self.points:
                continue
            views = [(f, kp) for f, kp in self.tracks[tid].items()
                     if f in self.registered]
            if len(views) < 2:
                continue
            centers = np.stack([self._center(f) for f, _ in views])
            d2 = ((centers[:, None] - centers[None]) ** 2).sum(-1)
            a, b = np.unravel_index(np.argmax(d2), d2.shape)
            if d2[a, b] <= 0:
                continue
            (fi, ki), (fj, kj) = views[a], views[b]
            X = cv2.triangulatePoints(self._proj(fi), self._proj(fj),
                                      self.kps[fi][ki].reshape(2, 1),
                                      self.kps[fj][kj].reshape(2, 1))
            xyz = (X[:3, 0] / (X[3, 0] if abs(X[3, 0]) > 1e-12 else 1e-12))
            if self._accept_point(tid, xyz):
                self.points[tid] = xyz

    def _accept_point(self, tid, xyz, max_err_px=4.0, min_angle_deg=1.5):
        rays = []
        for frame, kp in self.tracks[tid].items():
            if frame not in self.registered:
                continue
            R, t = self.registered[frame]
            xc = R @ xyz + t
            if xc[2] < 1e-3:
                return False
            uv = self.K @ xc
            uv = uv[:2] / uv[2]
            if np.linalg.norm(uv - self.kps[frame][kp]) > max_err_px:
                return False
            d = xyz - self._center(frame)
            rays.append(d / max(np.linalg.norm(d), 1e-12))
        # Triangulation-angle gate: a point supported only by
        # near-parallel rays has unbounded depth error — poison for BA.
        rays = np.stack(rays)
        cosmin = ((rays @ rays.T)).min()
        return np.degrees(np.arccos(np.clip(cosmin, -1, 1))) \
            >= min_angle_deg

    def _pnp_from_guess(self, obj, img, rvec0, tvec0, max_px=4.0,
                        rounds=2):
        """Iterative PnP seeded by a neighbor pose: refine on all
        points, then re-fit on reprojection inliers. Returns
        (rvec, tvec, n_inliers) or (None, None, 0) without consensus."""
        cv2 = _cv2()
        rvec, tvec = rvec0.copy(), tvec0.copy()
        keep = np.ones(len(obj), bool)
        for _ in range(rounds):
            if keep.sum() < 6:
                return None, None, 0
            ok, rvec, tvec = cv2.solvePnP(
                obj[keep], img[keep], self.K, None, rvec=rvec, tvec=tvec,
                useExtrinsicGuess=True, flags=cv2.SOLVEPNP_ITERATIVE)
            if not ok or not (np.isfinite(rvec).all()
                              and np.isfinite(tvec).all()):
                return None, None, 0
            proj, _ = cv2.projectPoints(obj, rvec, tvec, self.K, None)
            res = np.linalg.norm(proj.reshape(-1, 2) - img, axis=1)
            keep = res < max_px
        n_inl = int(keep.sum())
        if n_inl < max(10, 0.3 * len(obj)):
            return None, None, 0
        return rvec, tvec, n_inl

    def _next_frame(self):
        best, best_count = None, 0
        for f in range(len(self.images)):
            if f in self.registered or f in self.failed:
                continue
            count = sum(1 for tid, frames in self._frame_tracks(f)
                        if tid in self.points)
            if count > best_count:
                best, best_count = f, count
        return best, best_count

    def _frame_tracks(self, f):
        for (frame, kp), tid in self.track_of_kp.items():
            if frame == f:
                yield tid, (frame, kp)

    def _register(self, f):
        cv2 = _cv2()
        obj, img = [], []
        for (frame, kp), tid in list(self.track_of_kp.items()):
            if frame != f or tid not in self.points:
                continue
            obj.append(self.points[tid])
            img.append(self.kps[f][kp])
        if len(obj) < 6:
            return False
        # Initialize from the nearest registered frame: scene points are
        # often near-planar (one wall fills the view) and planar PnP has
        # a two-fold ambiguity — an unanchored RANSAC can register the
        # frame into a displaced "ghost" branch that then seeds ghost
        # triangulations. On a continuous capture the neighbor pose is a
        # strong prior, so iterative PnP from it (refine, gate inliers,
        # re-fit) beats RANSAC's random minimal subsets; RANSAC remains
        # the fallback when the prior-seeded fit finds no consensus.
        obj = np.asarray(obj, np.float64)
        img = np.asarray(img, np.float64)
        nearest = min(self.registered, key=lambda g: abs(g - f))
        rvec0 = cv2.Rodrigues(self.registered[nearest][0])[0]
        tvec0 = self.registered[nearest][1].reshape(3, 1).copy()
        rvec, tvec, n_inl = self._pnp_from_guess(obj, img, rvec0, tvec0)
        if rvec is None:
            ok, rvec, tvec, inl = cv2.solvePnPRansac(
                obj, img, self.K, None, rvec=rvec0.copy(),
                tvec=tvec0.copy(), useExtrinsicGuess=True,
                reprojectionError=4.0, iterationsCount=200,
                flags=cv2.SOLVEPNP_ITERATIVE)
            if (not ok or inl is None
                    or len(inl) < max(10, 0.4 * len(obj))):
                return False
        R, _ = cv2.Rodrigues(rvec)
        if not (np.isfinite(R).all() and np.isfinite(tvec).all()):
            return False
        # Step-plausibility gate: RANSAC's hypothesis draws ignore the
        # extrinsic guess, so a ghost-branch pose can still win the
        # vote. On a continuous capture the new center must land within
        # a few typical inter-frame steps of its nearest registered
        # neighbor.
        new_center = -R.T @ tvec.ravel()
        regs = sorted(self.registered)
        if len(regs) >= 3:
            steps = [np.linalg.norm(self._center(a) - self._center(b))
                     for a, b in zip(regs[:-1], regs[1:])
                     if b - a <= 2]
            if steps:
                allowed = 10.0 * np.median(steps) * max(
                    abs(f - nearest), 1)
                if np.linalg.norm(new_center - self._center(nearest)) \
                        > allowed:
                    return False
        self.registered[f] = (R, tvec.ravel())
        self._triangulate_tracks(
            tid for tid in (self.track_of_kp.get((f, k))
                            for k in range(len(self.kps[f])))
            if tid is not None)
        return True

    # ------------------------------------------------------------ BA
    def _observations(self):
        cams = sorted(self.registered)
        cam_of = {f: i for i, f in enumerate(cams)}
        pids = sorted(t for t in self.points
                      if any(f in self.registered for f in self.tracks[t]))
        pid_of = {t: i for i, t in enumerate(pids)}
        cam_idx, pt_idx, xy = [], [], []
        for tid in pids:
            for frame, kp in self.tracks[tid].items():
                if frame in self.registered:
                    cam_idx.append(cam_of[frame])
                    pt_idx.append(pid_of[tid])
                    xy.append(self.kps[frame][kp])
        return cams, pids, (np.array(cam_idx), np.array(pt_idx),
                            np.array(xy))

    def _run_ba(self, refine_focal=False, max_iters=15, huber_px=4.0):
        cams, pids, (cam_idx, pt_idx, xy) = self._observations()
        if len(pids) < 8 or len(cams) < 2:
            return
        rvecs = np.stack([rotmat_to_rvec(self.registered[f][0])
                          for f in cams])
        tvecs = np.stack([self.registered[f][1] for f in cams])
        pts = np.stack([self.points[t] for t in pids])
        intr = (self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2])
        rvecs, tvecs, pts, intr, rms = bundle_adjust(
            rvecs, tvecs, pts, intr, cam_idx, pt_idx, xy,
            max_iters=max_iters, refine_focal=refine_focal,
            huber_px=huber_px, device=self.device)
        R_all = rodrigues(torch.as_tensor(rvecs)).numpy()
        for i, f in enumerate(cams):
            self.registered[f] = (R_all[i], tvecs[i])
        for i, t in enumerate(pids):
            self.points[t] = pts[i]
        self.K[0, 0], self.K[1, 1] = intr[0], intr[1]
        self.ba_rms_px = rms

    def _prune_outliers(self, max_px=8.0):
        """Drop observations whose post-BA reprojection error exceeds
        max(3 * median, max_px); drop points left with < 2 views."""
        cams, pids, (cam_idx, pt_idx, xy) = self._observations()
        if len(pids) == 0:
            return 0
        R = np.stack([self.registered[f][0] for f in cams])
        t = np.stack([self.registered[f][1] for f in cams])
        P = np.stack([self.points[p] for p in pids])
        Xc = np.einsum('nij,nj->ni', R[cam_idx], P[pt_idx]) + t[cam_idx]
        z = np.where(np.abs(Xc[:, 2:3]) < 1e-9, 1e-9, Xc[:, 2:3])
        uv = (Xc[:, :2] / z) @ np.diag([self.K[0, 0], self.K[1, 1]]) \
            + np.array([self.K[0, 2], self.K[1, 2]])
        res = np.linalg.norm(uv - xy, axis=1)
        bad = (res > max(3 * float(np.median(res)), max_px)) \
            | (Xc[:, 2] < 1e-3)
        # Walk the same (track, frame) order _observations used.
        k = 0
        n_dropped = 0
        for tid in pids:
            for frame in list(self.tracks[tid]):
                if frame not in self.registered:
                    continue
                if bad[k]:
                    kp = self.tracks[tid].pop(frame)
                    self.track_of_kp.pop((frame, kp), None)
                    n_dropped += 1
                k += 1
            views = sum(1 for fr in self.tracks[tid]
                        if fr in self.registered)
            if views < 2:
                self.points.pop(tid, None)
        return n_dropped

    def _drop_pose_outliers(self):
        """Drop registered frames whose median reprojection error is an
        outlier — a ghost-branch pose survives PnP gates occasionally
        but cannot reproject the shared structure."""
        cams, pids, (cam_idx, pt_idx, xy) = self._observations()
        if len(pids) == 0 or len(cams) < 4:
            return 0
        R = np.stack([self.registered[f][0] for f in cams])
        t = np.stack([self.registered[f][1] for f in cams])
        P = np.stack([self.points[p] for p in pids])
        Xc = np.einsum('nij,nj->ni', R[cam_idx], P[pt_idx]) + t[cam_idx]
        z = np.where(np.abs(Xc[:, 2:3]) < 1e-9, 1e-9, Xc[:, 2:3])
        uv = (Xc[:, :2] / z) @ np.diag([self.K[0, 0], self.K[1, 1]]) \
            + np.array([self.K[0, 2], self.K[1, 2]])
        res = np.linalg.norm(uv - xy, axis=1)
        global_med = float(np.median(res))
        dropped = 0
        for i, f in enumerate(cams):
            mine = res[cam_idx == i]
            if len(mine) and float(np.median(mine)) \
                    > max(3 * global_med, 8.0):
                del self.registered[f]
                self.failed.add(f)
                dropped += 1
        return dropped

    def _drop_tear_frames(self, factor=5.0):
        """Detect trajectory TEARS — displaced sub-maps that reproject
        their own (e.g. periodic-texture-aliased) tracks perfectly, so
        neither the reprojection-based pose-outlier drop nor the
        annealed-Huber BA can heal them. On a continuous capture the
        per-frame-gap-normalized center step is tightly distributed; a
        step many times the median marks a tear. Drop the frames outside
        the largest contiguous component (plus the structure only they
        support) so the second-chance growth pass can re-register them
        against the majority geometry."""
        regs = sorted(self.registered)
        if len(regs) < 6:
            return 0
        C = np.stack([self._center(f) for f in regs])
        steps = np.linalg.norm(np.diff(C, axis=0), axis=1)
        norm = steps / np.maximum(np.diff(regs), 1)
        # Robust motion scale: on stop-and-go captures (camera resting
        # >50% of frames) the plain median collapses to the noise floor
        # and every genuine move would read as a tear — take the median
        # over the MOVING steps only.
        moving = norm[norm > 0.05 * norm.mean()]
        med = float(np.median(moving if moving.size else norm))
        cuts = [k for k in range(len(norm))
                if norm[k] > factor * max(med, 1e-12)]
        if not cuts:
            return 0
        bounds = [0] + [k + 1 for k in cuts] + [len(regs)]
        comps = [regs[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        keep = set(max(comps, key=len))
        dropped = 0
        for f in regs:
            if f not in keep:
                del self.registered[f]
                dropped += 1
        if dropped:
            for tid in list(self.points):
                views = sum(1 for fr in self.tracks[tid]
                            if fr in self.registered)
                if views < 2:
                    self.points.pop(tid, None)
        return dropped

    def _grow(self, refine_focal, ba_every):
        since_ba = 0
        while True:
            f, count = self._next_frame()
            if f is None or count < 6:
                break
            if not self._register(f):
                # Avoid retrying the same frame forever (this pass).
                self.failed.add(f)
                continue
            since_ba += 1
            if since_ba >= ba_every:
                self._run_ba(refine_focal=refine_focal)
                # New registrations widen baselines: retry tracks that
                # previously failed the triangulation-angle gate.
                self._triangulate_tracks(list(self.tracks))
                since_ba = 0

    # ------------------------------------------------------------ run
    def run(self, refine_focal=False, ba_every=8, verbose=False):
        if self.detector_kind == 'klt':
            self._build_tracks_klt()
        else:
            self._extract()
            self._build_tracks()
        self._init_pair()
        self._grow(refine_focal, ba_every)
        self._triangulate_tracks(list(self.tracks))
        self._run_ba(refine_focal=refine_focal, max_iters=30)
        self._prune_outliers()
        if self._drop_pose_outliers() > 0:
            self._run_ba(refine_focal=refine_focal, max_iters=20)
        # Second chance for frames that failed registration: the map is
        # denser and the poses are refined now.
        self.failed.clear()
        self._grow(refine_focal, ba_every)
        self._triangulate_tracks(list(self.tracks))
        # Annealed robust kernel: a wide Huber first, so long-range
        # (anti-drift) constraints whose residuals reflect accumulated
        # drift can pull the sequence together instead of being treated
        # as outliers; then tighten and prune.
        self._run_ba(refine_focal=refine_focal, max_iters=30,
                     huber_px=16.0)
        self._run_ba(refine_focal=refine_focal, max_iters=30)
        if self._prune_outliers() > 0:
            self._run_ba(refine_focal=refine_focal, max_iters=20)
        # Tears (displaced sub-maps held together by aliased tracks)
        # survive everything above; excise and re-grow against the
        # majority geometry.
        if self._drop_tear_frames() > 0:
            self.failed.clear()
            self._grow(refine_focal, ba_every)
            self._triangulate_tracks(list(self.tracks))
            self._run_ba(refine_focal=refine_focal, max_iters=30)
            if self._prune_outliers() > 0:
                self._run_ba(refine_focal=refine_focal, max_iters=20)
        if verbose:
            print(f'SfM: {len(self.registered)}/{len(self.images)} frames, '
                  f'{len(self.points)} points, '
                  f'BA rms {getattr(self, "ba_rms_px", float("nan")):.2f}px')
        return self

    # --------------------------------------------------------- export
    def write_colmap_model(self, model_dir):
        """COLMAP text model (OPENCV camera, zero distortion) for the
        ScaleEstimation / PoseSaver stages."""
        h, w = self.images[0].shape[:2]
        camera = ColmapCamera(
            camera_id=1, model='OPENCV', width=w, height=h,
            params=np.array([self.K[0, 0], self.K[1, 1], self.K[0, 2],
                             self.K[1, 2], 0.0, 0.0, 0.0, 0.0]))
        kp_point = {}
        for tid in self.points:
            for frame, kp in self.tracks[tid].items():
                kp_point[(frame, kp)] = tid
        images = []
        for idx, f in enumerate(sorted(self.registered)):
            R, t = self.registered[f]
            p2d = [ColmapPoint2D(xy=self.kps[f][kp],
                                 point3D_id=kp_point[(f, kp)])
                   for (frame, kp) in sorted(kp_point)
                   if frame == f]
            images.append(ColmapImage(
                image_id=idx + 1, qvec=rotmat_to_qvec(R), tvec=t,
                camera_id=1, name=self.names[f], points2D=p2d))
        points3D = {
            tid: ColmapPoint3D(id=tid, xyz=xyz,
                               rgb=np.array([128, 128, 128]), error=1.0)
            for tid, xyz in self.points.items()}
        write_text_model(model_dir, camera, images, points3D)
