"""Port parity of the matcher at the CLI's size: ``ops/matching.match`` of
both packages on the oracle harness's first tracked pair (frame 1 against
keyframe 0 of ``run_oracle_slam``: ``OracleScene(seed=0)``,
``make_trajectory(24)`` at full amplitude, σ_point 0.003, σ_desc 0.02),
identity start, the tracker's FAST settings.

The two matchers are the same algorithm; they part only through float32
rounding. The port's ray image differs from XLA's in the last bit
(``rsqrt``: ≤ 1.8e-7 at 384x512, on 40% of the ray pixels and ~87% of the
gradient pixels), and the LM's reductions round apart. A converged query
then ends ~0.01 px away in the other package (the accept / reject test
compares costs at their rounding floor, and some optima sit on a pixel
line where the bilinear cost has a kink); when ``floor`` of the two
positions lands in different pixels, the descriptor refine starts one pixel
apart and may end 1-3 pixels apart. The refine, the occlusion gate and the
``proj_step`` upsampling give identical results on identical inputs; the
LM does not (its cost's ``rsqrt`` and sums round apart too), so the two
loops part even on the same ray image. The steps where the queries part
are not near-singular.

``python tests/test_torch_matcher_parity.py`` prints the shares per size
and, for every differing valid pixel, the LM iteration where its query
parts and the relative determinant of that 2x2 step in both packages, and
how far the two LMs part on the same inputs;
``--oracle-run`` also runs both packages' ``run_oracle_slam`` at 384x512
(full amplitude, FAST, rays, ``kf_every 4``) and prints their keyframes,
BA edges and tracked poses (minutes on the CPU)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mast3r_slam_tpu.ops import matching as JMa
from mast3r_slam_tpu_torch.ops import matching as TMa
from mast3r_slam_tpu_torch.utils.oracle_scene import (OracleScene,
                                                       make_trajectory)
from torch_parity import torch_one_thread  # noqa: F401

FRAMES = 24
SIGMA_POINT, SIGMA_DESC = 0.003, 0.02
# tests/test_oracle_modes.py FAST, as the harness's tracker applies it
FAST_TRACK = dict(radius=2, dilation_max=1, max_iter=10, refine_mode="plus",
                  level_step=2, plateau_frac=0.001, proj_step=2)
LAMBDA, COST_THRESH = 1e-8, 1e-6


def oracle_pair(hw):
    """``run_oracle_slam``'s arguments to its first ``match`` call: frame
    1's noisy pointmap and descriptors, keyframe 0's points seen from frame
    1 (noisy) and its descriptors, with the harness's noise stream (every
    frame's point and descriptor draws, then the cross map's)."""
    scene = OracleScene(seed=0)
    poses = make_trajectory(FRAMES)
    K = scene.intrinsics(hw)
    n = hw[0] * hw[1]
    rng = np.random.default_rng(0)
    Xs, Ds, hits = [], [], []
    for f in range(FRAMES):
        if f < 2:
            X, h = scene.raycast(poses[f], K, hw)
            D = scene.descriptors(h)
        else:           # the same draws, without the ray-cast
            X, D, h = np.zeros((n, 3)), np.zeros((n, Ds[0].shape[1])), None
        Xn = X + (SIGMA_POINT * X[:, 2:3]
                  * rng.standard_normal(X.shape)).astype(np.float32)
        Dn = D + SIGMA_DESC * rng.standard_normal(D.shape).astype(np.float32)
        Dn /= np.linalg.norm(Dn, axis=-1, keepdims=True) + 1e-12
        Xs.append(Xn)
        Ds.append(Dn)
        hits.append(h)
    Xk = scene.world_to_cam(hits[0], poses[1]).astype(np.float32)
    Xk = Xk + (SIGMA_POINT * Xk[:, 2:3]
               * rng.standard_normal(Xk.shape)).astype(np.float32)
    H, W = hw
    return [np.asarray(a, np.float32).reshape(1, H, W, -1)
            for a in (Xs[1], Xk, Ds[1], Ds[0])]


def match_both(pair, **kw):
    """``(idx, valid)`` of each package, numpy, identity start."""
    n = pair[0].shape[1] * pair[0].shape[2]
    init = np.arange(n)[None]
    ji, jv = JMa.match(*(jnp.asarray(a) for a in pair),
                       idx_1_to_2_init=jnp.asarray(init), **kw)
    ti, tv = TMa.match(*(torch.from_numpy(a) for a in pair),
                       idx_1_to_2_init=torch.from_numpy(init), **kw)
    return ((np.asarray(ji)[0], np.asarray(jv)[0, :, 0]),
            (ti.numpy()[0], tv.numpy()[0, :, 0]))


def shares(jax_out, port_out):
    (ji, jv), (ti, tv) = jax_out, port_out
    both = jv & tv
    return dict(n=ji.size, valid_jax=int(jv.sum()), valid_port=int(tv.sum()),
                valid_differ=int((jv != tv).sum()),
                idx_agree=float((ji == ti).mean()),
                valid_idx_agree=float((ji == ti)[both].mean()),
                valid_differing=np.nonzero((ji != ti) & both)[0])


def test_matcher_agrees_with_jax_at_384x512():
    """The measured agreement (PERF.md §7): at 384x512 the valid masks
    differ on 4 of 196,608 pixels (one LM query whose cost sits on the
    1e-6 threshold, times the 2x2 ``proj_step`` block) and ``idx`` agrees
    on 99.15% of all pixels and on 179 of the 181 pixels valid in both."""
    pair = oracle_pair((384, 512))
    s = shares(*match_both(pair, **FAST_TRACK))
    assert s["valid_jax"] > 100 and s["valid_port"] > 100
    assert s["valid_differ"] <= 8
    assert s["idx_agree"] >= 0.99
    assert s["valid_idx_agree"] >= 0.98


# --------------------------------------------------------------------------
# the report: where the differing pixels' LM queries part
# --------------------------------------------------------------------------

def _lm_positions(pkg, r9, pn, pi, iters):
    """Positions of every LM query after 0..iters iterations (the loop run
    to each ``max_iter``; the plateau exit is global, so a truncated run is
    the full run's state at that iteration)."""
    out = []
    for k in range(iters + 1):
        if pkg == "jax":
            p, _ = JMa.iter_proj(jnp.asarray(r9), jnp.asarray(pn),
                                 jnp.asarray(pi), k, LAMBDA, COST_THRESH,
                                 FAST_TRACK["plateau_frac"])
            out.append(np.asarray(p)[0])
        else:
            p, _ = TMa.iter_proj(torch.from_numpy(r9), torch.from_numpy(pn),
                                 torch.from_numpy(pi), k, LAMBDA,
                                 COST_THRESH, FAST_TRACK["plateau_frac"])
            out.append(p.numpy()[0])
    return np.stack(out)


def _relative_det(r9, uv):
    """``|a00 a11 - a01²| / (a00 a11)`` of the Gauss-Newton 2x2 system at
    positions ``uv (Q, 2)`` (float64 bilinear samples of the gradient
    channels; the LM damping, 1e-8 at the start, is left out)."""
    H, W = r9.shape[1:3]
    img = r9[0].astype(np.float64)
    u, v = uv[:, 0].astype(np.float64), uv[:, 1].astype(np.float64)
    u0 = np.clip(np.floor(u).astype(int), 0, W - 2)
    v0 = np.clip(np.floor(v).astype(int), 0, H - 2)
    du, dv = (u - u0)[:, None], (v - v0)[:, None]
    s = ((img[v0, u0] * (1 - du) + img[v0, u0 + 1] * du) * (1 - dv)
         + (img[v0 + 1, u0] * (1 - du) + img[v0 + 1, u0 + 1] * du) * dv)
    gx, gy = s[:, 3:6], s[:, 6:9]
    a00, a01, a11 = (gx * gx).sum(-1), (gx * gy).sum(-1), (gy * gy).sum(-1)
    return np.abs(a00 * a11 - a01 * a01) / (a00 * a11)


def report(hw, proj_step=2):
    kw = dict(FAST_TRACK, proj_step=proj_step)
    pair = oracle_pair(hw)
    s = shares(*match_both(pair, **kw))
    n_differ = round((1 - s['idx_agree']) * s['n'])
    print(f"{hw[0]}x{hw[1]} proj_step {proj_step}: valid jax "
          f"{s['valid_jax']} port {s['valid_port']}, masks differ on "
          f"{s['valid_differ']} of {s['n']}; idx agree on "
          f"{s['idx_agree']:.6f} of all pixels ({n_differ} differ), on "
          f"{s['valid_idx_agree']:.6f} of the pixels valid in both "
          f"({len(s['valid_differing'])} differ)")
    H, W = hw
    preps = {
        "jax": [np.array(a) for a in JMa.prep_for_iter_proj(
            *(jnp.asarray(a) for a in pair[:2]), None)],
        "port": [a.numpy() for a in TMa.prep_for_iter_proj(
            *(torch.from_numpy(a) for a in pair[:2]), None)]}
    r9j, r9t = preps["jax"][0], preps["port"][0]
    print(f"  ray image: max abs difference {np.abs(r9j - r9t).max():.2e}; "
          f"pixels differing per channel "
          f"{np.round((r9j != r9t).reshape(-1, 9).mean(0), 3).tolist()}")
    st = proj_step
    hc, wc = H // st, W // st
    sel = ((np.arange(hc) * st)[:, None] * W
           + (np.arange(wc) * st)[None, :]).reshape(-1)
    traj = {pkg: _lm_positions(pkg, r9, pn[:, sel], pi[:, sel],
                               kw["max_iter"])
            for pkg, (r9, pn, pi) in preps.items()}
    dets = []
    for i, p in enumerate(s["valid_differing"]):
        y, x = divmod(int(p), W)
        q = (y // st) * wc + x // st
        tj, tt = traj["jax"][:, q], traj["port"][:, q]
        gap = np.abs(tj - tt).max(-1)
        first = int(np.argmax(gap > 0)) if (gap > 0).any() else -1
        wide = int(np.argmax(gap > 1e-3)) if (gap > 1e-3).any() else -1
        k = max(wide, 1) - 1
        rd_j = _relative_det(r9j, tj[k][None])[0]
        rd_t = _relative_det(r9t, tt[k][None])[0]
        dets.append(min(rd_j, rd_t))
        if i >= 5:
            continue
        print(f"  pixel ({y}, {x}): query ({y // st}, {x // st}) parts at "
              f"iteration {first} (any bit), beyond 1e-3 px at iteration "
              f"{wide}; final positions {tj[-1].round(4).tolist()} (jax) "
              f"{tt[-1].round(4).tolist()} (port); relative det of that "
              f"step {rd_j:.3f} (jax) {rd_t:.3f} (port)")
    if dets:
        print(f"  {len(dets)} differing valid pixels: relative det of the "
              f"parting step median {np.median(dets):.3f}, below 1e-2 on "
              f"{sum(d < 1e-2 for d in dets)}")
    conv_gap = np.abs(traj["jax"][-1] - traj["port"][-1]).max(-1)
    rd_all = _relative_det(r9t, traj["port"][-1])
    print(f"  LM queries: {conv_gap.size}; final positions differ on "
          f"{int((conv_gap > 0).sum())}, beyond 1e-3 px on "
          f"{int((conv_gap > 1e-3).sum())}; relative det at the port's end "
          f"positions: median {np.median(rd_all):.3f}, 1st percentile "
          f"{np.percentile(rd_all, 1):.2e}")
    # the same inputs in both loops: what the LM's own arithmetic parts
    r9, pn, pi = preps["jax"]
    same = _lm_positions("port", r9, pn[:, sel], pi[:, sel], kw["max_iter"])
    gap = np.abs(traj["jax"] - same).max(-1)
    for k in (1, kw["max_iter"]):
        print(f"  the port's LM on JAX's ray image and queries, after {k} "
              f"iteration(s): positions differ on {int((gap[k] > 0).sum())}"
              f", beyond 1e-3 px on {int((gap[k] > 1e-3).sum())}, by up to "
              f"{gap[k].max():.2e} px")
    return s


def oracle_runs(hw):
    """Both packages' oracle harness at ``hw``, full amplitude: keyframes,
    whether the BA got edges, tracked ATE and keyframe-pose differences."""
    from mast3r_slam_tpu.utils import oracle_scene as JO
    from mast3r_slam_tpu_torch.utils import oracle_scene as TO

    fast = dict(refine_mode="plus", level_step=2, plateau_frac=0.001,
                radius=2, proj_step=2, track_dilation_max=1,
                ba_pixel_step=2, ba_meas_dtype="bfloat16",
                ba_compute_dtype="bfloat16", ba_delta_norm=1e-2)
    poses = make_trajectory(FRAMES)
    rj = JO.run_oracle_slam(JO.OracleScene(seed=0), poses, hw, fast,
                            kf_every=4)
    rt = TO.run_oracle_slam(TO.OracleScene(seed=0), poses, hw, fast,
                            kf_every=4, device="cpu")
    for name, r in (("jax", rj), ("port", rt)):
        # the JAX harness returns the tracked poses as its BA poses when
        # every edge fell under its 20% valid gate; the port's also says so
        # with ``ba_problem`` None
        moved = not np.array_equal(np.asarray(r["T_kf_ba"]),
                                   np.asarray(r["T_kf_track"]))
        print(f"oracle {hw[0]}x{hw[1]} {name}: keyframes {r['kf_ids']}, "
              f"skipped {r['n_skipped']}, BA moved the poses: {moved}, ATE "
              f"track {r['ate_track'] * 1e3:.3f} mm, ATE BA "
              f"{r['ate_ba'] * 1e3:.3f} mm, mean pixel error "
              f"{r['mean_pix_err']:.3f}")
    d = np.abs(np.asarray(rt["T_kf_track"]) - np.asarray(rj["T_kf_track"]))
    print(f"  tracked keyframe poses, max abs difference per keyframe: "
          f"{np.round(d.max(-1), 6).tolist()}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    sizes = [(96, 128), (192, 256), (384, 512)]
    for hw in sizes:
        report(hw)
    if "--proj-step-1" in sys.argv:
        report((384, 512), proj_step=1)
    if "--oracle-run" in sys.argv:
        oracle_runs((384, 512))
