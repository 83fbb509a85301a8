"""Where the port's camera path parts from the JAX package's, frame by frame, on the CPU.

Both runs below start every frame from ONE JAX state, so what they compare is
a single step, not a trajectory that has already drifted.

``--corridor N`` (phase 4's corridor, ``tools/jax_reference_camlidar.json``'s
inputs, the polar2 ingest): the JAX package's per-frame chain
(``visual_frontend.chunk_frame_step`` under ``jax.jit``, the tracker's levels
on ``pallas_lk.lk_level`` in interpret mode) runs frames 1..N. At each frame
four trackers see the JAX state: the JAX tracker, the JAX tracker with every
feature position moved up by one ulp (``np.nextafter``), the port's tracker
(``lk_level_plain``, the bits of kernel K6) and the port's tracker on the
nudged positions. A feature is *sensitive* to an implementation when the
one-ulp nudge moves its tracked position by more than ``SENSITIVE_PX`` or flips
its ok flag. The tool lists, a frame, the features where the port and JAX
differ by more than ``SENSITIVE_PX`` or in the ok flag, and those of them that
are sensitive in neither implementation (``unexplained``): differences in
rounding explain the others. It also gives the frame's relative pose
difference (port step against JAX step from the same state: the largest
axis, and the signed vector beside JAX's step, to show a bias), and the
stages after tracking fed the same inputs: the depth gates on JAX's tracks
(the largest depth difference, the features whose depth differs by more
than 1 mm, the active / has-depth / epipolar flags that differ; and the same
two figures for JAX's own gates run under ``jax.disable_jit()`` against its
jitted ones) and the pose solve on JAX's gates (the largest translation
difference).

Three sides are then held to yardsticks of their own, each frame from the
same JAX state: the port, JAX jitted and JAX eager (the frame step, gates
and solve under ``jax.disable_jit()``, the tracker still on the
interpret-mode kernel). Each side's whole step and its ``depth_gates`` +
``solve_pose`` chain on JAX's jitted tracks give a signed translation
beside JAX jitted's and beside the ground-truth camera step. A float64
oracle of ``associate_depth`` (``depth_oracle``: brute-force 3-NN by exact
differences, the same determinant ratio, clamps and gates, on JAX's float32
query and depth cloud cast to float64) judges each side's
``associate_depth`` on that same query: (i) features whose 3-NN set differs
from float64's, (ii) on equal sets the depth error (median, 99th
percentile, signed mean), (iii) the ``ok`` flags that differ, and the
depths more than 1 mm off split into neighbour flips and determinant
rounding. ``summary`` gives, a side, the lateral (x) lean of its steps (sum,
mean, standard error, Wilcoxon signed-rank p) and the totals of (i)-(iii).
About 45 s a frame, most of it the eager step.

``--write-steps`` (``rotation_heavy`` and ``revisit_out_and_back`` at 1800
samples, ``tools/jax_reference_regimes.json``'s inputs, the polar ingest, the
packed images of the native packer): the same JAX chain over every frame,
keeping at frames ``STEP_FRAMES`` the carried state (the feature table, the
world pose and the warm start), the step JAX takes from it (relative pose,
tracked count), and the steps it takes from the state nudged by one ulp
(every feature position up, every one down, the world translation up): how
far rounding alone moves JAX's own step there. Writes them to
``tools/jax_reference_regime_steps.npz``, which ``chip_smoke.py`` phase 11
reads, then runs the port's step from each state on the CPU
(``chip_smoke.regime_camera_steps``) and prints the differences.
``--write-steps corridor`` does the same on phase 4's corridor (the inputs
of ``tools/jax_reference_camlidar.json``, the polar2 ingest, the range-only
images of the native packer) at frames 4, 8, ..., 48, and writes
``tools/jax_reference_corridor_steps.npz``, which phase 4 reads; bare
``--write-steps`` writes both files.

Scans and images are rendered in threads with numpy's BLAS held to one thread
(ROADMAP C.5) and must hash as the references' inputs. About ten minutes for
the regimes, five for the corridor's states.

    python tools/camera_step_diff.py [--corridor 10] [--write-steps [regimes,corridor]] [--out FILE]
    python tools/camera_step_diff.py --corridor 48 --out FILE    # C.7's table, about 40 min
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy import stats as sstats  # noqa: E402

import chip_smoke  # noqa: E402
from jax_reference_camlidar import (  # noqa: E402
    bench_config, inputs_sha256, lk_through_pallas_interpret, render,
)
from jax_reference_regimes import VISUAL, regimes  # noqa: E402
from lidar_visual_odometry_tpu.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu.data.native_pack import pack_polar_chunk  # noqa: E402
from lidar_visual_odometry_tpu.models import cam_lidar_pipeline as jcl  # noqa: E402
from lidar_visual_odometry_tpu.models import visual_frontend as jvf  # noqa: E402
from lidar_visual_odometry_tpu.ops import camera as jcam  # noqa: E402
from lidar_visual_odometry_tpu.ops import image as jimage  # noqa: E402
from lidar_visual_odometry_tpu.ops import knn as jknn  # noqa: E402
from lidar_visual_odometry_tpu.ops import lk as jlk  # noqa: E402
from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf  # noqa: E402
from lidar_visual_odometry_tpu_torch.ops import camera as tcam  # noqa: E402
from lidar_visual_odometry_tpu_torch.ops import knn as tknn  # noqa: E402
from lidar_visual_odometry_tpu_torch.ops import se3  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config  # noqa: E402

SENSITIVE_PX = 1e-3
DEPTH_APART_M = 1e-3
SIDES = ("port", "jax_jit", "jax_eager")
STEP_FRAMES = slice(2, None, 4)   # frames 2, 6, 10, ... (frame 1's previous image is float)
CORRIDOR_STEP_FRAMES = slice(4, None, 4)   # frames 4, 8, ..., 48


def _uint8(im):
    return np.clip(im * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _render(seqs, visual):
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        out = {}
        for name, seq in seqs.items():
            scans = list(ex.map(seq.scan, range(seq.n_frames)))
            images = (list(ex.map(partial(render, seq), range(seq.n_frames)))
                      if name in visual else [])
            out[name] = scans, images
    return out


class JaxChain:
    """The JAX visual frontend frame by frame from frame 0 (as
    ``CamLidarPipeline.run_chunked`` starts it), on natively packed images."""

    def __init__(self, scans, images, channels):
        cfg = bench_config()
        self.vcfg, lcfg = cfg.visual, cfg.lidar
        E = np.asarray(cfg.extrinsic.matrix, np.float32)
        R_cl, t_cl = E[:, :3], np.ascontiguousarray(E[:, 3])
        self.cam = jcam.Pinhole.from_config(cfg.camera)
        cx0, cm0 = jcl.camera_cloud_select(scans[0][:, :3], R_cl, t_cl,
                                           self.vcfg.depth_cloud_cap)
        packed = pack_polar_chunk([s[:, :3] for s in scans[1:]], n_scans=lcfg.n_scans,
                                  width=lcfg.azimuth_bins, min_range=lcfg.min_range,
                                  max_range=lcfg.max_range, channels=channels)
        self.imgs8 = [None] + [_uint8(im) for im in images[1:]]
        self.state = jvf.init_chunk_state(jnp.asarray(np.asarray(images[0], np.float32)),
                                          jnp.asarray(cx0), jnp.asarray(cm0), self.cam,
                                          self.vcfg)
        clouds, masks = jcl.cam_clouds_from_polar(jnp.asarray(packed), jnp.asarray(R_cl),
                                                  jnp.asarray(t_cl), lcfg,
                                                  self.vcfg.depth_cloud_cap)
        self.clouds = [None] + list(np.asarray(clouds))
        self.masks = [None] + list(np.asarray(masks))
        self._step = jax.jit(jvf.chunk_frame_step, static_argnames=("cfg",))
        self.k = 1

    def step(self):
        """Frame ``k`` from the carried state: (relative pose, tracked count)."""
        k = self.k
        self.state, rel, n = self._step(self.state, jnp.asarray(self.imgs8[k]), self.clouds[k],
                                        self.masks[k], self.cam, self.vcfg)
        self.k += 1
        return rel, int(n)

    def step_from(self, state):
        """Frame ``k``'s step from another state, the chain unmoved."""
        _, rel, _ = self._step(state, jnp.asarray(self.imgs8[self.k]), self.clouds[self.k],
                               self.masks[self.k], self.cam, self.vcfg)
        return rel

    def pyramid(self, k):
        v = self.vcfg
        img = jnp.asarray(self.imgs8[k]).astype(jnp.float32) * (1.0 / 255.0)
        if v.use_clahe:
            img = jimage.clahe(img, grid=v.clahe_grid, clip_limit=v.clahe_clip)
        return tuple(jimage.build_pyramid(img, v.lk_levels))


def _ulp(x, direction):
    x = np.asarray(x)
    return jnp.asarray(np.nextafter(x, np.float32(direction)).astype(np.float32))


def _nudged_states(st):
    """The state with every feature position one ulp up, one ulp down, and
    with the world translation one ulp up: inputs that rounding alone could
    have given."""
    return (st._replace(table=st.table._replace(uv=_ulp(st.table.uv, np.inf))),
            st._replace(table=st.table._replace(uv=_ulp(st.table.uv, -np.inf))),
            st._replace(pose_w=st.pose_w._replace(t=_ulp(st.pose_w.t, np.inf))))


def _port_state(js):
    def t(x):
        return torch.from_numpy(np.array(x))
    return vf.VisualChunkState(
        vf.FeatureTable(*(t(x) for x in js.table)), se3.Pose(*(t(x) for x in js.pose_w)),
        se3.Pose(*(t(x) for x in js.warm_rel)), tuple(t(x) for x in js.prev_pyr),
        vf.DepthCloud(*(t(x) for x in js.prev_dc)))


def _apart(uv_a, ok_a, uv_b, ok_b) -> set:
    """Features whose tracked positions lie more than SENSITIVE_PX apart
    (where both are ok) or whose ok flags differ."""
    d = np.abs(uv_a - uv_b).max(axis=1)
    return set(np.nonzero(((ok_a & ok_b) & (d > SENSITIVE_PX)) | (ok_a != ok_b))[0].tolist())


def depth_oracle(un, active, plane10, z, mask):
    """``visual_frontend.associate_depth`` in float64 on float32 inputs: the
    3-NN of the query (10·un, 10) by exact differences over the masked cloud
    (the lower index first among equal distances), the determinant ratio of
    the ray and the neighbours' plane, and the same clamps and gates.
    Returns (depth, ok, the 3-NN indices in ascending order)."""
    un = np.asarray(un, np.float64)
    q = np.concatenate([10.0 * un, np.full((len(un), 1), 10.0)], axis=1)
    valid = np.nonzero(np.asarray(mask))[0]
    cloud = np.asarray(plane10, np.float64)
    c = cloud[valid]
    idx = np.empty((len(q), 3), np.int64)
    dist = np.empty((len(q), 3))
    for a in range(0, len(q), 64):
        d = sum((q[a:a + 64, None, i] - c[None, :, i]) ** 2 for i in range(3))
        sel = np.argsort(d, axis=1, kind="stable")[:, :3]
        idx[a:a + 64] = valid[sel]
        dist[a:a + 64] = np.take_along_axis(d, sel, axis=1)
    zn = np.asarray(z, np.float64)[idx]
    px = cloud[idx][..., 0] * zn / 10.0
    py = cloud[idx][..., 1] * zn / 10.0
    (x1, x2, x3), (y1, y2, y3), (z1, z2, z3) = px.T, py.T, zn.T
    u, v = un[:, 0], un[:, 1]
    num = (x1 * y2 * z3 - x1 * y3 * z2 - x2 * y1 * z3
           + x2 * y3 * z1 + x3 * y1 * z2 - x3 * y2 * z1)
    den = (x1 * y2 - x2 * y1 - x1 * y3 + x3 * y1 + x2 * y3 - x3 * y2
           + u * y1 * z2 - u * y2 * z1 - v * x1 * z2 + v * x2 * z1
           - u * y1 * z3 + u * y3 * z1 + v * x1 * z3 - v * x3 * z1
           + u * y2 * z3 - u * y3 * z2 - v * x2 * z3 + v * x3 * z2)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = num / np.where(np.abs(den) > 1e-12, den, 1e-12)
    zmin, zmax = zn.min(axis=1), zn.max(axis=1)
    s = np.where(np.isfinite(s), s, z1)
    s = np.where(s - zmax > 0.2, zmax, s)
    s = np.where(s - zmin < -0.2, zmin, s)
    ok = (np.asarray(active) & (dist[:, 0] < 0.5) & np.isfinite(dist).all(axis=1)
          & (zmax - zmin <= 2.0) & (s > 0))
    return np.where(ok, s, 0.0), ok, np.sort(idx, axis=1)


def judge_depths(depth, ok, idx, active, oracle) -> tuple[dict, np.ndarray]:
    """One side's ``associate_depth`` (its depths, ok flags and 3-NN
    indices) against ``depth_oracle``'s on the same query: (i) active
    features whose 3-NN set differs, (ii) the depth error on equal sets
    where both are ok, (iii) the ok flags that differ, and the depths more
    than ``DEPTH_APART_M`` off split into neighbour flips and rounding.
    Returns the record and (ii)'s signed errors."""
    d64, ok64, idx64 = oracle
    same = (np.sort(np.asarray(idx), axis=1) == idx64).all(axis=1)
    ok = np.asarray(ok)
    both = ok & ok64
    err = np.asarray(depth, np.float64) - d64
    e = err[same & both]
    apart = both & (np.abs(err) > DEPTH_APART_M)
    rec = {"nn_set_differs": int((np.asarray(active) & ~same).sum()),
           "equal_sets_ok": int(e.size),
           "depth_err_median_m": float(np.median(np.abs(e))) if e.size else 0.0,
           "depth_err_p99_m": float(np.quantile(np.abs(e), 0.99)) if e.size else 0.0,
           "depth_err_signed_mean_m": float(e.mean()) if e.size else 0.0,
           "ok_differs": int((ok != ok64).sum())}
    for name, sel in (("flip", apart & ~same), ("rounding", apart & same)):
        rec[f"apart_{name}"] = int(sel.sum())
        rec[f"apart_{name}_max_m"] = float(np.abs(err[sel]).max()) if sel.any() else 0.0
    return rec, e


def lean(xs) -> dict:
    """A series of signed lateral differences: sum, mean, standard error,
    the count below zero and the Wilcoxon signed-rank p (zeros dropped)."""
    x = np.asarray(xs, np.float64)
    p = float(sstats.wilcoxon(x).pvalue) if np.count_nonzero(x) > 1 else 1.0
    return {"n": int(x.size), "sum_m": float(x.sum()), "mean_m": float(x.mean()),
            "sem_m": float(x.std(ddof=1) / np.sqrt(x.size)) if x.size > 1 else 0.0,
            "negative": int((x < 0).sum()), "wilcoxon_p": p}


def summarize(rows: list, errors: dict) -> dict:
    """The corridor's one-line summary: each side's lateral lean (its step,
    and its chain on JAX's tracks, against JAX jitted's and against the
    ground truth) and the totals of the oracle's (i)-(iii)."""
    out = {}
    for key in ("step_vs_jit", "step_vs_gt", "tracks_vs_jit", "tracks_vs_gt"):
        out[key] = {side: lean([r[key][side][0] for r in rows]) for side in rows[0][key]}
    tot = {}
    for side in SIDES:
        recs = [r["oracle"][side] for r in rows]
        e = np.concatenate(errors[side]) if errors[side] else np.zeros(0)
        tot[side] = {k: sum(rec[k] for rec in recs) for k in (
            "nn_set_differs", "equal_sets_ok", "ok_differs", "apart_flip", "apart_rounding")}
        tot[side].update(
            apart_flip_max_m=max(rec["apart_flip_max_m"] for rec in recs),
            apart_rounding_max_m=max(rec["apart_rounding_max_m"] for rec in recs),
            depth_err_median_m=float(np.median(np.abs(e))) if e.size else 0.0,
            depth_err_p99_m=float(np.quantile(np.abs(e), 0.99)) if e.size else 0.0,
            depth_err_signed_mean_m=float(e.mean()) if e.size else 0.0)
    out["oracle"] = tot
    return out


def _gt_camera_steps(seq, n):
    """The true T_cur_prev translation of the camera at frames 1..n."""
    cams = [synthetic.camera_from_velodyne_pose(*seq.pose(k)) for k in range(n + 1)]
    return [None] + [cams[k][0].T @ (cams[k - 1][1] - cams[k][1]) for k in range(1, n + 1)]


def corridor(n_frames: int) -> dict:
    with open(os.path.join(HERE, "jax_reference_camlidar.json")) as f:
        ref = json.load(f)
    seq = synthetic.SyntheticSequence(n_frames=ref["frames"], width=1800, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)
    scans, images = _render({"corridor": seq}, ("corridor",))["corridor"]
    digest = inputs_sha256(*scans, *images)
    if digest != ref["inputs_sha256"]:
        raise SystemExit(f"the corridor hashes to {digest[:16]}, the reference's inputs to "
                         f"{ref['inputs_sha256'][:16]}")
    tcfg = camlidar_config()
    tcam_ = tcam.Pinhole.from_config(tcfg.camera, device="cpu")
    rows = []
    with lk_through_pallas_interpret():
        chain = JaxChain(scans[:n_frames + 1], images[:n_frames + 1], channels=1)
        v = chain.vcfg
        track = jax.jit(lambda pp, p, uv, a, f: jlk.track_pyramid_reverse_checked(
            pp, p, uv, a, f, win=v.lk_window, iters=v.lk_iters, levels=v.lk_levels,
            max_reverse_err=v.reverse_check_px, reverse_levels=v.lk_reverse_levels or None,
            iters_coarse=v.lk_iters_coarse or None, eps=v.lk_eps, affine=v.lk_affine,
            reverse_affine=v.lk_reverse_affine))
        gates = jax.jit(jvf.depth_gates)
        solve = jax.jit(jvf.solve_pose, static_argnames=("cfg",))
        assoc = jax.jit(jvf.associate_depth)

        def nn3(un, dc):    # associate_depth's 3-NN, as it computes the query
            q = jnp.concatenate([10.0 * un, jnp.full((un.shape[0], 1), 10.0, un.dtype)], axis=-1)
            return jknn.knn(q, dc.plane10, dc.mask, 3)[0]

        nn3_jit = jax.jit(nn3)
        gt_steps = _gt_camera_steps(seq, n_frames)
        errors = {side: [] for side in SIDES}
        for k in range(1, n_frames + 1):
            st = chain.state
            pyr = chain.pyramid(k)
            uv0 = np.asarray(st.table.uv)
            nudged = np.nextafter(uv0, np.float32(np.inf)).astype(np.float32)
            j_uv, j_ok = map(np.asarray, track(st.prev_pyr, pyr, st.table.uv, st.table.active,
                                               st.table.flow))
            jn_uv, jn_ok = map(np.asarray, track(st.prev_pyr, pyr, jnp.asarray(nudged),
                                                 st.table.active, st.table.flow))
            ps = _port_state(st)
            tpyr = tuple(torch.from_numpy(np.array(p)) for p in pyr)
            p_uv, p_ok = (x.numpy() for x in vf._track(ps.prev_pyr, tpyr, ps.table, tcfg.visual))
            pn_uv, pn_ok = (x.numpy() for x in vf._track(
                ps.prev_pyr, tpyr, ps.table._replace(uv=torch.from_numpy(nudged)), tcfg.visual))
            _, p_rel, p_n = vf.chunk_frame_step(
                ps, torch.from_numpy(chain.imgs8[k]), torch.from_numpy(chain.clouds[k]),
                torch.from_numpy(chain.masks[k]), tcam_, tcfg.visual)
            with jax.disable_jit():     # JAX's frame step one operation at a time
                _, e_rel, _ = jvf.chunk_frame_step(st, jnp.asarray(chain.imgs8[k]),
                                                   chain.clouds[k], chain.masks[k], chain.cam, v)
            j_rel, j_n = chain.step()
            # the stages after tracking, both fed JAX's tracks: the depth
            # gates, then the pose solve fed JAX's gates
            jg = gates(jnp.asarray(j_uv), jnp.asarray(j_ok), st.prev_dc, st.table, st.pose_w,
                       chain.cam)
            pg = vf.depth_gates(torch.from_numpy(j_uv), torch.from_numpy(j_ok), ps.prev_dc,
                                ps.table, ps.pose_w, tcam_)
            d_depth = np.abs(pg[3].numpy() - np.asarray(jg[3]))
            with jax.disable_jit():     # JAX's own gates rounded one operation at a time
                je = jvf.depth_gates(jnp.asarray(j_uv), jnp.asarray(j_ok), st.prev_dc, st.table,
                                     st.pose_w, chain.cam)
            d_eager = np.abs(np.asarray(je[3]) - np.asarray(jg[3]))
            g_rel = vf.solve_pose(ps.warm_rel, *(torch.from_numpy(np.array(x)) for x in jg[1:]),
                                  tcfg.visual)
            jg_rel = solve(st.warm_rel, *jg[1:], v)
            # each side's gates and solve on JAX's tracks
            pg_rel = vf.solve_pose(ps.warm_rel, *pg[1:], tcfg.visual)
            with jax.disable_jit():
                je_rel = jvf.solve_pose(st.warm_rel, *je[1:], v)
            # each side's associate_depth on one query, against float64
            un, act = np.asarray(jg[1]), np.asarray(jg[0])
            oracle = depth_oracle(un, act, *(np.asarray(x) for x in st.prev_dc))
            tun, tact = torch.from_numpy(un), torch.from_numpy(act)
            q = torch.cat([10.0 * tun, torch.full_like(tun[:, :1], 10.0)], dim=-1)
            with jax.disable_jit():
                eager_assoc = (*jvf.associate_depth(jnp.asarray(un), jnp.asarray(act),
                                                    st.prev_dc),
                               nn3(jnp.asarray(un), st.prev_dc))
            judged = {}
            for side, (dep, okd, idx) in (
                    ("port", (*(x.numpy() for x in vf.associate_depth(tun, tact, ps.prev_dc)),
                              tknn.knn(q, ps.prev_dc.plane10, ps.prev_dc.mask, 3)[0].numpy())),
                    ("jax_jit", (*assoc(jnp.asarray(un), jnp.asarray(act), st.prev_dc),
                                 nn3_jit(jnp.asarray(un), st.prev_dc))),
                    ("jax_eager", eager_assoc)):
                judged[side], e = judge_depths(np.asarray(dep), np.asarray(okd), np.asarray(idx),
                                               act, oracle)
                errors[side].append(e)
            gt_t = gt_steps[k]

            def signed(a, b):
                return (np.asarray(a, np.float64) - np.asarray(b, np.float64)).tolist()
            apart = _apart(p_uv, p_ok, j_uv, j_ok)
            j_sens = _apart(jn_uv, jn_ok, j_uv, j_ok)
            p_sens = _apart(pn_uv, pn_ok, p_uv, p_ok)
            both = j_ok & p_ok
            rows.append({
                "frame": k,
                "port_vs_jax": sorted(apart),
                "ok_flips": sorted(np.nonzero(j_ok != p_ok)[0].tolist()),
                "jax_sensitive": sorted(j_sens),
                "port_sensitive": sorted(p_sens),
                "unexplained": sorted(apart - j_sens - p_sens),
                "tracked_ok": [int(j_ok.sum()), int(p_ok.sum())],
                "uv_p99_px": float(np.quantile(np.abs(p_uv - j_uv)[both].max(axis=1), 0.99)),
                "step_dt_m": float(np.abs(p_rel.t.numpy() - np.asarray(j_rel.t)).max()),
                "gates_depth_max_m": float(d_depth.max()),
                "gates_depth_features": int((d_depth > 1e-3).sum()),
                "jax_eager_gates_depth_max_m": float(d_eager.max()),
                "jax_eager_gates_depth_features": int((d_eager > 1e-3).sum()),
                "gates_flag_flips": int(sum((a.numpy() != np.asarray(b)).sum()
                                            for i, (a, b) in enumerate(zip(pg, jg))
                                            if i in (0, 4, 5))),
                "solve_same_inputs_dt_m": float(np.abs(g_rel.t.numpy()
                                                       - np.asarray(jg_rel.t)).max()),
                # signed: the port's step minus JAX's, and JAX's step itself
                "step_d_t": (p_rel.t.numpy() - np.asarray(j_rel.t)).astype(float).tolist(),
                "jax_step_t": np.asarray(j_rel.t).astype(float).tolist(),
                "tracked": [j_n, int(p_n)],
                # signed translations: each side's step, and its gates and
                # solve on JAX's jitted tracks, against JAX jitted's and the truth
                "step_vs_jit": {"port": signed(p_rel.t.numpy(), j_rel.t),
                                "jax_eager": signed(e_rel.t, j_rel.t)},
                "step_vs_gt": {"port": signed(p_rel.t.numpy(), gt_t),
                               "jax_jit": signed(j_rel.t, gt_t),
                               "jax_eager": signed(e_rel.t, gt_t)},
                "tracks_vs_jit": {"port": signed(pg_rel.t.numpy(), jg_rel.t),
                                  "jax_eager": signed(je_rel.t, jg_rel.t)},
                "tracks_vs_gt": {"port": signed(pg_rel.t.numpy(), gt_t),
                                 "jax_jit": signed(jg_rel.t, gt_t),
                                 "jax_eager": signed(je_rel.t, gt_t)},
                "oracle": judged,
            })
            print(json.dumps(rows[-1]), flush=True)
    summary = summarize(rows, errors)
    print(json.dumps({"summary": summary}), flush=True)
    return {"frames": rows, "summary": summary}


def _keep_states(name, scans, images, channels, keep, arrays) -> None:
    """Run the JAX chain over every frame of one sequence and keep, at the
    frames ``keep``, the carried state, JAX's step from it and its steps
    from the three one-ulp nudges, under ``{name}:...`` in ``arrays``."""
    arrays[f"{name}:frames"] = np.asarray(keep, np.int32)
    arrays[f"{name}:channels"] = np.asarray(channels, np.int32)
    t0 = time.time()
    with lk_through_pallas_interpret():
        chain = JaxChain(scans, images, channels=channels)
        for k in range(1, max(keep) + 1):
            st = chain.state
            if k in keep:
                nudged = [chain.step_from(s) for s in _nudged_states(st)]
            rel, n = chain.step()
            if k not in keep:
                continue
            leaves = (*st.table, *st.pose_w, *st.warm_rel)
            for i, leaf in enumerate(leaves):
                arrays[f"{name}:{k}:vchunk_{i}"] = np.asarray(leaf)
            arrays[f"{name}:{k}:rel_q"] = np.asarray(rel.q)
            arrays[f"{name}:{k}:rel_t"] = np.asarray(rel.t)
            arrays[f"{name}:{k}:tracked"] = np.asarray(n, np.int32)
            arrays[f"{name}:{k}:nudged_rel_q"] = np.stack([np.asarray(r.q) for r in nudged])
            arrays[f"{name}:{k}:nudged_rel_t"] = np.stack([np.asarray(r.t) for r in nudged])
    print(f"{name}: {len(keep)} states kept in {time.time() - t0:.1f} s", flush=True)


def _port_steps(inputs, path) -> list:
    rows = chip_smoke.regime_camera_steps(inputs, "cpu", path)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


def write_steps(path: str) -> dict:
    with open(os.path.join(HERE, "jax_reference_regimes.json")) as f:
        ref = json.load(f)
    seqs = {name: seq for name, seq in regimes(ref["width"]).items() if name in VISUAL}
    inputs = _render(seqs, VISUAL)
    arrays = {}
    for name, (scans, images) in inputs.items():
        digest = inputs_sha256(*scans, *images)
        if digest != ref["regimes"][name]["inputs_sha256"]:
            raise SystemExit(f"{name} hashes to {digest[:16]}, the reference's inputs to "
                             f"{ref['regimes'][name]['inputs_sha256'][:16]}")
        _keep_states(name, scans, images, 2, list(range(len(scans)))[STEP_FRAMES], arrays)
    np.savez_compressed(path, **arrays)
    return {"port_cpu_steps": _port_steps(inputs, path)}


def write_corridor_steps(path: str) -> dict:
    """Phase 4's corridor: ``tools/jax_reference_camlidar.json``'s inputs,
    the polar2 ingest (the range-only images), the states at
    ``CORRIDOR_STEP_FRAMES``."""
    with open(os.path.join(HERE, "jax_reference_camlidar.json")) as f:
        ref = json.load(f)
    seq = synthetic.SyntheticSequence(n_frames=ref["frames"], width=1800, speed=1.0,
                                      yaw_rate=0.004, noise=0.01)
    scans, images = _render({"corridor": seq}, ("corridor",))["corridor"]
    digest = inputs_sha256(*scans, *images)
    if digest != ref["inputs_sha256"]:
        raise SystemExit(f"the corridor hashes to {digest[:16]}, the reference's inputs to "
                         f"{ref['inputs_sha256'][:16]}")
    arrays = {}
    _keep_states("corridor", scans, images, 1,
                 list(range(len(scans)))[CORRIDOR_STEP_FRAMES], arrays)
    np.savez_compressed(path, **arrays)
    return {"port_cpu_steps": _port_steps({"corridor": (scans, images)}, path)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corridor", type=int, default=10, metavar="N",
                    help="frames of phase 4's corridor to compare (0: none)")
    ap.add_argument("--write-steps", nargs="?", const="regimes,corridor", default="",
                    metavar="regimes,corridor",
                    help="write tools/jax_reference_regime_steps.npz (regimes) and "
                         "tools/jax_reference_corridor_steps.npz (corridor), and run the port "
                         "on each")
    ap.add_argument("--steps-path", default=os.path.join(HERE, "jax_reference_regime_steps.npz"))
    ap.add_argument("--corridor-steps-path",
                    default=os.path.join(HERE, "jax_reference_corridor_steps.npz"))
    ap.add_argument("--out", default=None, help="also write the result here as JSON")
    args = ap.parse_args()
    out = {"sensitive_px": SENSITIVE_PX}
    if args.corridor:
        out["corridor"] = corridor(args.corridor)
    which = set(filter(None, args.write_steps.split(",")))
    if which - {"regimes", "corridor"}:
        raise SystemExit(f"--write-steps takes regimes and corridor, got {args.write_steps}")
    if "regimes" in which:
        out["regimes"] = write_steps(args.steps_path)
    if "corridor" in which:
        out["corridor_steps"] = write_corridor_steps(args.corridor_steps_path)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps({k: v for k, v in out.items() if k != "corridor"}))


if __name__ == "__main__":
    main()
