"""The port's CLI (``mast3r_slam_tpu_torch/main.py``) on the CPU against the
JAX CLI (``main.py``): the same tiny weights (npz) on the same synthetic
TUM clip, and on a EuRoC-layout clip (gray, undistorted as it is read), a
Replica clip of JPEG frames (baseline and progressive) and an image folder
of mixed PNG kinds (EXIF-tagged, 16-bit, interlaced, palette), must give
the same per-frame mode sequence,
keyframes and edges, and trajectories within ``TRAJ_TOL``. Further runs of the port's CLI
(calibrated, ``img_downsample 2``, threaded, retrieval artifacts,
checkpoint / resume) are checked as tests/test_e2e_smoke.py checks the JAX
CLI, and the ATE / RPE scorers against the JAX ones.

The weights are JAX ``init_params`` of ``tiny_config`` with the second
decoder stream and head tied to the first (``torch_parity.tiny_weights``):
a frame decoded against its keyframe then predicts consistent geometry,
so tracking succeeds and the clip exercises keyframing, retrieval edges and
the BA instead of falling into RELOC at frame 1.
"""

import os
import pathlib
import time

import jax
import numpy as np
import pytest
import torch
import yaml

from mast3r_slam_tpu_torch import evaluation as TE
from mast3r_slam_tpu_torch import main as tcli
from mast3r_slam_tpu_torch.data import png
from mast3r_slam_tpu_torch.slam import tracker as TT
from torch_jpeg_writer import write_jpeg
from torch_png_writer import exif_orientation, stored_under
from torch_png_writer import write_png as write_png_kind
from torch_parity import tiny_weights, torch_one_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
N_FRAMES = 11              # out 5 steps and back: no two frames alike in a row
# The clip is made at the model crop (64x96 at img_size 96), so that both
# packages' resize is the identity and both models see the same input bits:
# with random weights a 1e-6 input difference (the port's resize against
# cv2's) grows into 0.1-2 pose differences within a few frames.
CLIP_HW = (64, 96)
CLIP_STEP = (2.0, 0.7)
# While every tracked frame's matches agree index for index, the poses agree
# to f32 rounding of the solves (POSE_TOL). A random-weight matcher puts a
# few pixels on near-singular LM steps (ROADMAP queue 3: >= 99.5% index
# agreement); on this clip one flips at the sixth tracked frame (steps of
# 1.5 or 3.0 px flip at the second), and from there each pose solve and BA
# starts from a slightly different state and the random, inconsistent
# geometry carries the difference along the chain (0.02 read at the end).
# TRAJ_TOL bounds the exported trajectories at the end of the clip; the
# decisions (modes, keyframes, edges) are held exactly.
POSE_TOL = 1e-4
MIN_AGREEING_FRAMES = 4
TRAJ_TOL = 0.05
# keyframe decisions: min(match_frac_k, unique_frac_f) against
# tracking.match_frac_thresh
KF_THRESH = 0.9
# how long the viewer run's last frame waits for the viewer's first frame
VIEWER_WAIT_S = 60.0


def _frames(n, hw, step, seed):
    """Smooth texture panning out and back: uint8 RGB ``(H, W, 3)``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    freqs = rng.uniform(0.01, 0.05, (3, 2))
    phases = rng.uniform(0, 2 * np.pi, 3)
    for i in range(n):
        p = min(i, n - 1 - i)
        x, y = xx + step[0] * p, yy + step[1] * p
        img = np.stack([np.sin(fx * x + fy * y + ph)
                        for (fx, fy), ph in zip(freqs, phases)], -1)
        yield ((0.9 * img + 1.0) * 127.5).astype(np.uint8)


def _clip(root, n, hw=(480, 640), step=(12.0, 4.0), seed=0):
    """A TUM-format clip of smooth texture panning out and back."""
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    rows = []
    for i, img in enumerate(_frames(n, hw, step, seed)):
        png.write_png(root / "rgb" / f"{i:04d}.png", img)
        rows.append(f"{1e9 + i / 30.0:.6f} rgb/{i:04d}.png")
    (root / "rgb.txt").write_text("# ts file\n" + "\n".join(rows) + "\n")
    return root


# EuRoC MH cam0's calibration scaled to a CLIP_HW frame (the distortion
# coefficients act on normalized coordinates and keep their values)
EUROC_SCALE = CLIP_HW[1] / 752


def _euroc_clip(root, n):
    """A EuRoC-layout clip (mav0/cam0/data/<ns>.png, gray, sensor.yaml with
    distortion): every frame is undistorted as it is read."""
    cam = root / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(_frames(n, CLIP_HW, CLIP_STEP, 1)):
        png.write_png(cam / "data" / f"{1403636579763555584 + i * 50_000_000}"
                      ".png", img.mean(-1).astype(np.uint8))
    k = EUROC_SCALE
    (cam / "sensor.yaml").write_text(yaml.safe_dump({
        "intrinsics": [458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k],
        "distortion_coefficients": [-0.28340811, 0.07395907, 0.00019359,
                                    1.76187114e-05],
        "resolution": [CLIP_HW[1], CLIP_HW[0]]}))
    return root


def _replica_clip(root, n, progressive=False):
    """Replica's layout: results/frame%06d.jpg + cam_params.json."""
    (root / "results").mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(_frames(n, CLIP_HW, CLIP_STEP, 2)):
        write_jpeg(root / "results" / f"frame{i:06d}.jpg", img, 95,
                   progressive=progressive)
    h, w = CLIP_HW
    (root / "cam_params.json").write_text(
        f'{{"camera": {{"w": {w}, "h": {h}, "fx": {w / 2}, "fy": {w / 2}, '
        f'"cx": {(w - 1) / 2}, "cy": {(h - 1) / 2}}}}}')
    return root


def _video_clip(path, n, fourcc):
    """A video that cv2 writes (the JAX reader reads it through
    cv2.VideoCapture, the port through its own demuxer and decoder) of the
    TUM clip's texture and pan."""
    import cv2

    h, w = CLIP_HW
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30,
                         (w, h))
    for img in _frames(n, CLIP_HW, CLIP_STEP, 0):
        wr.write(np.ascontiguousarray(img[..., ::-1]))
    wr.release()
    return path


# the image folder's frames in turn: stored under the inverse of each
# EXIF orientation, 16-bit (v * 257), Adam7-interlaced, palette
PNG_KINDS = tuple(range(1, 9)) + ("16-bit", "adam7", "palette")


def _mixed_png_clip(root, n):
    """An image folder (``RGBFiles``) whose frames are PNGs of the kinds
    in ``PNG_KINDS``; a palette frame holds the frame quantized to a 6 x 6
    x 6 colour cube."""
    root.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(_frames(n, CLIP_HW, CLIP_STEP, 3)):
        kind = PNG_KINDS[i % len(PNG_KINDS)]
        path = root / f"frame{i:04d}.png"
        if kind == "16-bit":
            write_png_kind(path, img.astype(np.int64) * 257, depth=16)
        elif kind == "adam7":
            write_png_kind(path, img, interlace=True)
        elif kind == "palette":
            q = img.astype(np.int64) * 6 // 256
            cube = np.stack(np.meshgrid(*[np.arange(6) * 51] * 3,
                                        indexing="ij"), -1).reshape(-1, 3)
            write_png_kind(path, q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2],
                           palette=cube)
        else:
            write_png_kind(path, stored_under(img, kind),
                           exif=exif_orientation(kind, "MM" if kind % 2
                                                 else "II"))
    return root


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The clip, the tied tiny weights as a JAX npz, and the config (the
    unported services off, tests/test_e2e_smoke.py's cuts)."""
    from mast3r_slam_tpu.models import convert as JC

    base = tmp_path_factory.mktemp("cli")
    clip = _clip(base / "synth_tum_clip", N_FRAMES, hw=CLIP_HW,
                 step=CLIP_STEP)
    _, pj, _, _ = tiny_weights(tie_streams=True)
    weights = base / "tiny_tied.npz"
    JC.save_params_npz(pj, weights)
    cfg = {
        "inherit": str(REPO / "config" / "base.yaml"),
        "single_thread": True,
        "dataset": {"img_size": 96},
        "model": {"preset": "tiny"},
        # sigma_dist 0.1 pins the Sim(3) scale: at base.yaml's 10 the
        # distance rows weigh ~1e-7 of the ray rows and f32 rounding moves
        # the solved scale (tests/test_torch_tracker.py::_track_cfg)
        "tracking": {"min_match_frac": 0.0, "match_frac_thresh": KF_THRESH,
                     "Q_conf": 0.0, "sigma_dist": 0.1},
        # f32 channels and BA rows: bf16 row rounding alone moves a BA
        # solve by ~1e-4 between XLA and torch
        "local_opt": {"min_match_frac": 0.0, "Q_conf": 0.0,
                      "sigma_dist": 0.1, "meas_dtype": "float32",
                      "ba_compute_dtype": "float32"},
        "quality": {"enabled": False},
        "tsdf_refine": {"enabled": False},
        "tsdf_global": {"enabled": False},
    }
    cfg_path = base / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return base, clip, weights, cfg, cfg_path


def _write_cfg(setup, name, **over):
    from mast3r_slam_tpu_torch.utils.config import merge_config

    base, _, _, cfg, _ = setup
    path = base / f"{name}.yaml"
    path.write_text(yaml.safe_dump(merge_config(cfg, over)))
    return path


def _valid_idx(idx, valid):
    """A frame's matches as the pose solve sees them: the match index where
    the match is valid, -1 elsewhere."""
    idx = np.asarray(idx).reshape(-1)
    valid = np.asarray(valid).reshape(-1).astype(bool)
    return np.where(valid, idx, -1)


def _traj(path):
    return np.asarray([[float(v) for v in l.split()]
                       for l in pathlib.Path(path).read_text().splitlines()
                       if l.strip()])


def _both_cli_runs(setup, clip, tag):
    """One run of each CLI on ``clip``; the JAX one's per-frame modes are
    read from its ``States`` at each ``create_frame``; the port's
    keyframe-decision margins from its ``track_core`` outputs."""
    import main as jcli
    from mast3r_slam_tpu.parallel import topology
    from mast3r_slam_tpu.slam import tracker as JT

    base, _, weights, _, cfg_path = setup
    argv = ["--dataset", str(clip), "--config", str(cfg_path), "--no-viz",
            "--weights", str(weights)]
    cwd = os.getcwd()
    os.chdir(base)
    saved = (jcli.States, jcli.create_frame, TT.track_core, JT.track_core,
             topology.plan_topology, tcli.create_frame)
    j_track, t_track, j_frames, t_frames = [], [], [], []
    try:
        states, j_modes = [], []

        # the port runs its one-slot layout here (device="cpu"): the JAX
        # CLI gets the single-device topology, not the test process's 8
        # virtual CPU devices (the 8-slot run: test_torch_parallel.py)
        topology.plan_topology = lambda devices=None: saved[4](
            jax.devices()[:1])

        def rec_jtrack(*a, **kw):
            out = saved[3](*a, **kw)
            j_track.append((_valid_idx(out["idx_f2k"], out["valid_match"]),
                            np.asarray(out["T_WCf"])))
            return out

        class RecStates(jcli.States):
            def __init__(self):
                super().__init__()
                states.append(self)

        def rec_create(*a, **kw):
            j_modes.append(states[-1].get_mode().name)
            j_frames.append(np.array(a[1]))
            return saved[1](*a, **kw)

        jcli.States, jcli.create_frame = RecStates, rec_create
        JT.track_core = rec_jtrack
        j_out = jcli.main(argv + ["--save-as", f"jax_{tag}"])
        jcli.States, jcli.create_frame = saved[0], saved[1]

        margins = []

        def rec_core(*a, **kw):
            out = saved[2](*a, **kw)
            margins.append(min(float(out["match_frac_k"]),
                               float(out["unique_frac_f"])) - KF_THRESH)
            t_track.append((_valid_idx(out["idx_f2k"], out["valid_match"]),
                            out["T_WCf"].numpy()))
            return out

        def rec_tcreate(*a, **kw):
            t_frames.append(np.array(a[1]))
            return saved[5](*a, **kw)

        TT.track_core, tcli.create_frame = rec_core, rec_tcreate
        t_out = tcli.main(argv + ["--save-as", f"port_{tag}"], device="cpu")
    finally:
        (jcli.States, jcli.create_frame, TT.track_core, JT.track_core,
         topology.plan_topology, tcli.create_frame) = saved
        os.chdir(cwd)
    name = clip.name
    logs = base / "logs"
    return dict(j=j_out, t=t_out, j_modes=j_modes, margins=margins,
                j_track=j_track, t_track=t_track, j_frames=j_frames,
                t_frames=t_frames,
                j_traj=_traj(logs / f"jax_{tag}" / name / f"{name}.txt"),
                t_traj=_traj(logs / f"port_{tag}" / name / f"{name}.txt"))


@pytest.fixture(scope="module")
def both_runs(setup):
    return _both_cli_runs(setup, setup[1], "tum")


@pytest.fixture(scope="module", params=["euroc", "replica",
                                        "replica_progressive",
                                        "rgbfiles_mixed", "video_mjpg"])
def dataset_runs(request, setup):
    """The EuRoC-layout clip (undistorted on read), the Replica JPEG clip
    (baseline and progressive), the image folder of mixed PNG kinds and a
    Motion JPEG video through both CLIs."""
    base = setup[0]
    if request.param == "video_mjpg":
        clip = _video_clip(base / "clip_mjpg.avi", N_FRAMES, "MJPG")
    elif request.param == "euroc":
        clip = _euroc_clip(base / "euroc_MH_01_easy", N_FRAMES)
    elif request.param == "rgbfiles_mixed":
        clip = _mixed_png_clip(base / "frames_mixed_png", N_FRAMES)
    else:
        clip = _replica_clip(base / f"{request.param}_office0", N_FRAMES,
                             progressive=request.param.endswith("ive"))
    return _both_cli_runs(setup, clip, request.param)


def _check_modes(r, n_frames=N_FRAMES, min_margin=0.02):
    assert r["t"]["modes"] == r["j_modes"]
    assert r["t"]["modes"][0] == "INIT"
    assert r["t"]["frames_processed"] == r["j"]["frames_processed"] \
        == n_frames
    # every keyframe decision sits clear of the threshold (the smallest
    # margin is printed on failure)
    assert min(abs(m) for m in r["margins"]) > min_margin, r["margins"]


def _check_keyframes_and_edges(r, retrieval=True):
    kj, kt = r["j"]["keyframes"], r["t"]["keyframes"]
    n = len(kt)
    assert n == len(kj) >= 4
    np.testing.assert_array_equal(kt.dataset_idx[:n], kj.dataset_idx[:n])
    gj, gt = r["j"]["graph"], r["t"]["graph"]
    np.testing.assert_array_equal(np.asarray(gt.ii), np.asarray(gj.ii))
    np.testing.assert_array_equal(np.asarray(gt.jj), np.asarray(gj.jj))
    assert not retrieval or any(abs(int(i) - int(j)) > 1
                                for i, j in zip(gt.ii, gt.jj)), \
        "no retrieval edge"


def _check_frames(r, n_frames=N_FRAMES):
    """Both CLIs hand ``create_frame`` the same host frames, bit for bit."""
    jf, tf = r["j_frames"], r["t_frames"]
    assert len(jf) == len(tf) == n_frames
    for a, b in zip(jf, tf):
        assert (b.dtype, b.shape) == (a.dtype, a.shape)
        np.testing.assert_array_equal(b, a)


def _check_tracked_poses(r, min_agreeing=MIN_AGREEING_FRAMES):
    """Frame by frame: the same matches give the same pose (POSE_TOL); the
    first frame whose matches differ anywhere is where the chains part, and
    it comes after at least ``min_agreeing`` tracked frames. The first
    tracked frame starts from the same state in both CLIs, so its pose is
    held at POSE_TOL too where more than 99.9% of its matches agree. Every
    tracked frame agrees on at least 99.5% of its matches (a random-weight
    matcher flips a few pixels: ROADMAP queue 3)."""
    jt, tt = r["j_track"], r["t_track"]
    assert len(jt) == len(tt) == N_FRAMES - 1
    agree = [np.array_equal(a[0], b[0]) for a, b in zip(jt, tt)]
    share = [(a[0] == b[0]).mean() for a, b in zip(jt, tt)]
    first = agree.index(False) if False in agree else len(agree)
    assert first >= min_agreeing, agree
    held = max(first, int(share[0] > 0.999))
    assert held >= 1, share
    for (_, Ta), (_, Tb) in list(zip(jt, tt))[:held]:
        np.testing.assert_allclose(Tb, Ta, rtol=0, atol=POSE_TOL)
    assert min(share) >= 0.995, share


def _check_trajectories(r):
    tj, tt = r["j_traj"], r["t_traj"]
    assert tt.shape == tj.shape and tt.shape[1] == 8
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    np.testing.assert_allclose(tt[:, 1:], tj[:, 1:], rtol=0, atol=TRAJ_TOL)


def test_cli_frames_match_jax(both_runs):
    _check_frames(both_runs)


def test_cli_mode_sequence_matches_jax(both_runs):
    _check_modes(both_runs)


def test_cli_keyframes_and_edges_match_jax(both_runs):
    _check_keyframes_and_edges(both_runs)


def test_cli_tracked_poses_match_jax_while_matches_agree(both_runs):
    _check_tracked_poses(both_runs)


def test_cli_trajectories_match_jax(both_runs):
    _check_trajectories(both_runs)


@pytest.mark.parametrize("check", [
    _check_frames, _check_modes, _check_keyframes_and_edges,
    lambda r: _check_tracked_poses(r, min_agreeing=0), _check_trajectories],
    ids=["frames", "modes", "keyframes_edges", "tracked_poses",
         "trajectories"])
def test_cli_dataset_layouts_match_jax(dataset_runs, check):
    """EuRoC (gray, undistorted), Replica (baseline and progressive JPEG),
    image-folder (mixed PNG kinds, EXIF-tagged) and Motion JPEG video
    clips: both CLIs read the same frames bit for bit, and the TUM clip's checks hold at the
    same tolerances. On these clips the random-weight matcher flips a few
    pixels early (EuRoC 4 of 6,144 at the fourth tracked frame, Replica 5
    at the first), so no count of exactly agreeing frames is asked; the
    first tracked frame's pose is held at POSE_TOL on both."""
    check(dataset_runs)


@pytest.fixture(scope="module")
def mp4v_runs(setup):
    return _both_cli_runs(setup, _video_clip(setup[0] / "clip_mp4v.mp4",
                                             N_FRAMES, "mp4v"), "mp4v")


@pytest.mark.parametrize("check", [
    _check_frames, _check_modes,
    lambda r: _check_keyframes_and_edges(r, retrieval=False),
    lambda r: _check_tracked_poses(r, min_agreeing=0), _check_trajectories],
    ids=["frames", "modes", "keyframes_edges", "tracked_poses",
         "trajectories"])
def test_cli_mp4v_video_matches_jax(mp4v_runs, check):
    """An mp4v video (an I-VOP, then P-VOPs) through both CLIs: the layouts'
    checks, with the same keyframes and edges but no retrieval edge asked
    for. The pan back revisits no view exactly here: P-VOPs decode a
    revisited texture with other residuals, and the tiny random-weight
    retrieval links none of this clip's keyframes beyond their neighbours
    (nor did six other textures); the Motion JPEG clip, every frame intra,
    has its retrieval edge."""
    check(mp4v_runs)


@pytest.fixture(scope="module")
def xvid_b_runs(setup):
    return _both_cli_runs(setup, REPO / "tests" / "data" / "video" / "cli_640x480_xvid_b.avi",
                          "xvid_b")


@pytest.mark.parametrize("check", [
    lambda r: _check_frames(r, 16), lambda r: _check_modes(r, 16, min_margin=0.01),
    lambda r: _check_keyframes_and_edges(r, retrieval=False)],
    ids=["frames", "modes", "keyframes_edges"])
def test_cli_xvid_b_video_matches_jax(xvid_b_runs, check):
    """The committed 480x640 Xvid clip (XviD0064 user data, fourcc XVID:
    FFmpeg's Xvid IDCT; IBBP with B-VOPs in every mode, 4MV and AC
    prediction) through both CLIs, main.py -> load_dataset -> MP4Dataset:
    the same frames bit for bit (resized to the model crop), modes,
    keyframes and edges (no retrieval edge asked for, as for mp4v). Its
    closest keyframe decision sits 0.0123 from the threshold (measured), so
    the modes' margin guard is 0.01 here: both packages see the same input
    bits, and their scores differ by f32 rounding."""
    check(xvid_b_runs)


# ---------------------------------------------------------------------------
# Further runs of the port's CLI, checked as tests/test_e2e_smoke.py checks
# the JAX CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def big_clip(setup):
    """480x640 frames: these runs go through the resize and crop."""
    base = setup[0]
    return _clip(base / "synth_tum_big", 6)


def _run(setup, clip, save_as, cfg_path=None, extra=(), frames=None):
    base, _, weights, _, default_cfg = setup
    argv = ["--dataset", str(clip), "--config", str(cfg_path or default_cfg),
            "--no-viz", "--weights", str(weights), "--save-as", save_as,
            *extra]
    if frames:
        argv += ["--max-frames", str(frames)]
    cwd = os.getcwd()
    os.chdir(base)
    try:
        out = tcli.main(argv, device="cpu")
    finally:
        os.chdir(cwd)
    return out, base / "logs" / save_as / clip.name


def _check_outputs(out, savedir, name, n_kf_min=1):
    """Trajectory rows finite with unit quaternions, one per keyframe; both
    PLYs well formed (the quality one with its quality fields); the
    keyframe PNGs read back."""
    traj = _traj(savedir / f"{name}.txt")
    n = len(out["keyframes"])
    assert n >= n_kf_min and traj.shape == (n, 8)
    assert np.isfinite(traj).all()
    np.testing.assert_allclose(np.linalg.norm(traj[:, 4:8], axis=1), 1.0,
                               atol=1e-3)
    ply = (savedir / f"{name}.ply").read_bytes()
    assert ply.startswith(b"ply\nformat binary_little_endian 1.0\n")
    qply = (savedir / f"{name}_quality.ply").read_bytes()
    header = qply[:qply.index(b"end_header")].decode()
    assert "property float priority" in header
    assert "property int class_id" in header
    pngs = sorted((savedir / "keyframes").glob("*.png"))
    assert len(pngs) == n
    h, w = out["keyframes"].img_shapes[0][0]
    for p in pngs:
        assert png.read_png(p).shape[:2] == (h, w)
    return traj


def test_cli_runs_on_resized_frames(setup, big_clip):
    out, savedir = _run(setup, big_clip, "big")
    assert out["frames_processed"] == 6 and out["modes"][0] == "INIT"
    assert out["keyframes"].model_hw == (64, 96)
    _check_outputs(out, savedir, big_clip.name, n_kf_min=2)


def test_cli_calibrated(setup, big_clip):
    """--calib with use_calib: constrain-to-ray and the calibrated BA, K
    rescaled to the crop."""
    base = setup[0]
    cfg = _write_cfg(setup, "calib", use_calib=True)
    intr = base / "intr.yaml"
    intr.write_text(yaml.safe_dump({"width": 640, "height": 480, "fx": 500.0,
                                    "fy": 500.0, "cx": 320.0, "cy": 240.0}))
    out, savedir = _run(setup, big_clip, "calib", cfg, ["--calib", str(intr)],
                        frames=4)
    K = out["keyframes"].K
    assert K is not None
    np.testing.assert_allclose(K[0, 0].item(), 500.0 * 96 / 640, rtol=1e-5)
    _check_outputs(out, savedir, big_clip.name)


def test_cli_calib_file_with_distortion(setup, big_clip):
    """--calib config/intrinsics.yaml (freiburg1's calibration with k1..k3,
    the example the JAX CLI ships): every frame undistorted, and the BA's K
    is the undistorted camera's K_frame at the crop."""
    from mast3r_slam_tpu_torch.data.datasets import Intrinsics

    cfg = _write_cfg(setup, "calib_dist", use_calib=True)
    intr = REPO / "config" / "intrinsics.yaml"
    out, savedir = _run(setup, big_clip, "calib_dist", cfg,
                        ["--calib", str(intr)], frames=4)
    c = yaml.safe_load(intr.read_text())
    want = Intrinsics(c["width"], c["height"], c["fx"], c["fy"], c["cx"],
                      c["cy"], [c[k] for k in ("k1", "k2", "p1", "p2", "k3")],
                      cfg={"dataset": {"img_size": 96}})
    assert want.has_distortion
    np.testing.assert_array_equal(out["keyframes"].K.numpy(), want.K_frame)
    assert out["frames_processed"] == 4
    _check_outputs(out, savedir, big_clip.name)


def test_cli_downsampled(setup, big_clip):
    """dataset.img_downsample 2: pointmaps and matches at 32x48, the model
    at 64x96, the display image decimated."""
    cfg = _write_cfg(setup, "ds2", dataset={"img_downsample": 2})
    out, savedir = _run(setup, big_clip, "ds2", cfg)
    kf = out["keyframes"]
    assert (kf.h, kf.w) == (32, 48) and kf.model_hw == (64, 96)
    assert kf.uimg[0].shape == (32, 48, 3)
    _check_outputs(out, savedir, big_clip.name)


def test_cli_threaded_drains(setup, big_clip):
    cfg = _write_cfg(setup, "threaded", single_thread=False)
    out, savedir = _run(setup, big_clip, "threaded", cfg)
    st = out["states"]
    assert out["frames_processed"] == 6
    assert st.global_optimizer_tasks == [] and st.reloc_sem == 0
    _check_outputs(out, savedir, big_clip.name)


def test_cli_with_retrieval_artifacts(setup, big_clip):
    """A JAX-saved retrieval head (residual flag included) and a codebook
    .npy load, and the run uses them."""
    from mast3r_slam_tpu.models.convert import save_params_npz

    base = setup[0]
    rng = np.random.default_rng(9)
    D = 64
    head = {
        "prewhiten_m": rng.normal(size=D).astype(np.float32) * 0.1,
        "prewhiten_P": np.eye(D, dtype=np.float32)
        + 0.05 * rng.normal(size=(D, D)).astype(np.float32),
        "postwhiten_m": np.zeros(D, np.float32),
        "postwhiten_P": np.eye(D, dtype=np.float32),
        "projector": [{"w": np.eye(D, dtype=np.float32)
                       + 0.05 * rng.normal(size=(D, D)).astype(np.float32),
                       "b": np.zeros(D, np.float32)}],
        "residual": True,
    }
    save_params_npz(head, base / "head.npz")
    cb = rng.normal(size=(32, D)).astype(np.float32)
    np.save(base / "codebook.npy", cb / np.linalg.norm(cb, axis=1,
                                                       keepdims=True))
    out, savedir = _run(setup, big_clip, "retr", extra=[
        "--retrieval-weights", str(base / "head.npz"),
        "--retrieval-codebook", str(base / "codebook.npy")], frames=5)
    db = out["retrieval"]
    assert db.head_residual and db.codebook.shape == (32, D)
    assert db.kf_counter == len(out["keyframes"])
    _check_outputs(out, savedir, big_clip.name)


def test_cli_checkpoint_resume(setup, big_clip):
    """--checkpoint writes a snapshot whose restore equals the run's
    keyframes bit for bit; --resume continues from it."""
    from mast3r_slam_tpu_torch.slam.factor_graph import FactorGraph
    from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer
    from mast3r_slam_tpu_torch.utils.checkpoint import load_state

    base = setup[0]
    ckpt = base / "state.npz"
    out, _ = _run(setup, big_clip, "ck1", extra=["--checkpoint", str(ckpt)],
                  frames=3)
    kf, g = out["keyframes"], out["graph"]
    n = len(kf)
    kf2 = KeyframeBuffer(kf.h, kf.w, capacity=kf.capacity,
                         feat_dim=kf.feat_dim, device="cpu",
                         model_hw=kf.model_hw)
    g2 = FactorGraph(None, kf2, {"local_opt": {}})
    assert load_state(ckpt, kf2, g2) == 3 and len(kf2) == n
    for key in ("T_WC", "X", "C", "feat", "pos"):
        assert torch.equal(getattr(kf, key)[:n], getattr(kf2, key)[:n]), key
    for key in ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "Q_jj2ii"):
        assert torch.equal(getattr(g, key), getattr(g2, key)), key
    assert (kf2.xc_version[:n] >= 1).all()      # restored content bumped
    out2, savedir = _run(setup, big_clip, "ck2",
                         extra=["--resume", str(ckpt)])
    assert out2["frames_processed"] == 6
    assert len(out2["keyframes"]) >= n
    assert out2["retrieval"].kf_counter + len(
        out2["retrieval"]._pending) == len(out2["keyframes"])
    _check_outputs(out2, savedir, big_clip.name)


# ---------------------------------------------------------------------------
# The services: config/base.yaml's quality service and local TSDF refiner,
# and the global TSDF, in the port's CLI
# ---------------------------------------------------------------------------

# the JAX CLI's end-to-end smoke config's service settings
# (tests/test_e2e_smoke.py)
E2E_SERVICES = {
    "quality": {"enabled": True},
    "tsdf_refine": {"enabled": True, "window_size": 1, "ray_samples": 8,
                    "max_grid_dim": 16},
    "tsdf_global": {"enabled": True, "samples_per_kf": 64,
                    "max_points_per_kf": 256, "table_capacity": 65536},
}
BASE_SERVICES = {"quality": {"enabled": True},
                 "tsdf_refine": {"enabled": True}}


def _read_ply(path):
    """A binary little-endian PLY's vertex records as a structured array."""
    data = pathlib.Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    types = {"float": "<f4", "int": "<i4", "uchar": "u1"}
    props = [l.split()[1:] for l in data[:end].decode().splitlines()
             if l.startswith("property")]
    return np.frombuffer(data[end:], dtype=[(n, types[t]) for t, n in props])


def _run_services(setup, clip, name, over, monkeypatch):
    """The port's CLI with ``over`` merged into the test config, counting
    the quality jobs the tracker submits."""
    from mast3r_slam_tpu_torch.services import quality_async as QA

    submitted = []
    orig = QA.AsynchronousQualityService.submit

    def counted(self, job):
        submitted.append(job["frame_id"])
        return orig(self, job)

    monkeypatch.setattr(QA.AsynchronousQualityService, "submit", counted)
    out, savedir = _run(setup, clip, name, _write_cfg(setup, name, **over))
    return out, savedir, len(submitted)


def _check_services(out, savedir, name, submitted):
    """Every quality job processed or dropped, every refiner task ended,
    every worker stopped, and the quality PLY carrying non-zero fields."""
    q, ref = out["quality"], out["refiner"]
    assert submitted > 0
    assert q.processed_jobs + q.dropped_jobs == submitted
    assert not q.is_alive()
    s = ref.stats
    assert s["scheduled"] > 0
    assert s["refined_blocks"] + s["rejected_blocks"] == s["scheduled"], s
    assert not ref.is_alive()
    rec = _read_ply(savedir / f"{name}_quality.ply")
    assert rec.size > 0
    for field in ("r", "delta_cov", "u", "priority"):
        assert np.isfinite(rec[field]).all(), field
    # u is 0 here: the test config's C_conf = Q_conf = 0 saturate the
    # normalized confidences
    for field in ("r", "delta_cov"):
        assert (rec[field] != 0).any(), field


def test_cli_runs_base_yaml_services(setup, big_clip, monkeypatch):
    """config/base.yaml's quality service and local TSDF refiner (its
    shipped settings: patch 16, batch 4, G 64, 64 ray samples, 3 blocks a
    keyframe) in the tiny CLI run."""
    out, savedir, n = _run_services(setup, big_clip, "svc_base",
                                    BASE_SERVICES, monkeypatch)
    assert out["frames_processed"] == 6
    assert out["refiner"].max_grid_dim == 64
    assert not out["tsdf_manager"].enabled
    _check_services(out, savedir, big_clip.name, n)
    _check_outputs(out, savedir, big_clip.name)


def test_cli_runs_e2e_smoke_services_with_global_tsdf(setup, big_clip,
                                                      monkeypatch):
    """The JAX CLI's end-to-end smoke services, the global TSDF included:
    its volume holds voxels and its threads stop."""
    from mast3r_slam_tpu_torch.services.native_tsdf import NativeVoxelHash

    out, savedir, n = _run_services(setup, big_clip, "svc_e2e",
                                    E2E_SERVICES, monkeypatch)
    m = out["tsdf_manager"]
    assert m.enabled and isinstance(m.volume.hash, NativeVoxelHash)
    assert m.volume.stats()["voxels"] > 0
    assert m.integrator.integrated_until == len(out["keyframes"])
    assert not m.integrator.is_alive() and not m.opt_thread.is_alive()
    _check_services(out, savedir, big_clip.name, n)


def test_cli_threaded_with_services_drains(setup, big_clip, monkeypatch):
    over = dict(E2E_SERVICES, single_thread=False)
    out, savedir, n = _run_services(setup, big_clip, "svc_thr", over,
                                    monkeypatch)
    st = out["states"]
    assert out["frames_processed"] == 6
    assert st.global_optimizer_tasks == [] and st.reloc_sem == 0
    _check_services(out, savedir, big_clip.name, n)


def _run_with_viewer(setup, clip, save_as, monkeypatch):
    """The CLI without ``--no-viz`` (its viewer on EGL): the last frame
    waits until the viewer has drawn a frame (or stopped), so that the run
    is shown to go through the GL pipeline whatever the timing."""
    from mast3r_slam_tpu_torch.viz import viewer as tviewer

    started, make_frame = [], tcli.create_frame

    class Recorded(tviewer.Viewer):
        def start(self):
            started.append(self)
            super().start()

    def create_frame(i, *a, **kw):
        if i == N_FRAMES - 1:
            v = started[0]
            t0 = time.time()
            while (v.frames == 0 and v.error is None and v.is_alive()
                   and time.time() - t0 < VIEWER_WAIT_S):
                time.sleep(0.05)
        return make_frame(i, *a, **kw)

    monkeypatch.setattr(tcli, "Viewer", Recorded)
    monkeypatch.setattr(tcli, "create_frame", create_frame)
    base, _, weights, _, cfg_path = setup
    cwd = os.getcwd()
    os.chdir(base)
    try:
        out = tcli.main(["--dataset", str(clip), "--config", str(cfg_path),
                         "--weights", str(weights), "--save-as", save_as],
                        device="cpu")
    finally:
        os.chdir(cwd)
    assert out["viewer"] is started[0]
    return out


@pytest.mark.parametrize("service", ["quality", "tsdf_refine", "tsdf_global",
                                     "viewer"])
def test_cli_runs_each_service_and_the_viewer_and_needs_a_card(
        setup, service, monkeypatch):
    """Each service config runs (two frames); with its viewer (no
    ``--no-viz``) the CLI gives the same modes, keyframes and edges as
    without it, and the viewer draws (under EGL here) and stops at
    shutdown;
    without a card the default device raises instead of falling back to
    the CPU."""
    _, clip, _, _, cfg_path = setup
    if service == "viewer":
        out = _run_with_viewer(setup, clip, "viewer", monkeypatch)
        ref, _ = _run(setup, clip, "viewer_off")
        assert ref["viewer"] is None
        v = out["viewer"]
        assert not v.is_alive()
        if v.error is None:
            assert v.frames >= 1
        else:   # no GL stack: it stopped in init_gl and the run went on
            assert v.frames == 0 and not hasattr(v, "GL"), v.error
        assert out["modes"] == ref["modes"]
        assert len(out["keyframes"]) == len(ref["keyframes"])
        assert (list(out["graph"].ii), list(out["graph"].jj)) == (
            list(ref["graph"].ii), list(ref["graph"].jj))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA card"):
                tcli.main(["--dataset", str(clip), "--config", str(cfg_path),
                           "--no-viz"])
        return
    over = {service: dict(E2E_SERVICES[service],
                          min_shutdown_wait_s=0)}
    out, _ = _run(setup, clip, f"one_{service}",
                  _write_cfg(setup, f"one_{service}", **over), frames=2)
    assert out["frames_processed"] == 2
    on = {"quality": out["quality"] is not None,
          "tsdf_refine": out["refiner"].enabled,
          "tsdf_global": out["tsdf_manager"].enabled}
    assert on == {k: k == service for k in on}


# ---------------------------------------------------------------------------
# ATE / RPE against the JAX scorers
# ---------------------------------------------------------------------------

def test_ate_and_rpe_match_jax(tmp_path):
    from mast3r_slam_tpu import evaluation as JE

    rng = np.random.default_rng(1)
    ts = np.arange(40, dtype=np.float64) / 10
    pts = np.cumsum(rng.normal(size=(40, 3)) * 0.05, axis=0)
    qs = rng.normal(size=(40, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)

    def write(path, t, p, q):
        with open(path, "w") as f:
            for row in zip(t, p, q):
                f.write(" ".join(f"{v:.9f}" for v in
                                 [row[0], *row[1], *row[2]]) + "\n")

    gt, est = tmp_path / "gt.txt", tmp_path / "est.txt"
    write(gt, ts, pts, qs)
    noisy = 1.7 * pts + [1.0, -2.0, 0.5] + rng.normal(size=pts.shape) * 0.01
    write(est, ts[::2] + 0.004, noisy[::2], qs[::2])
    for align, scale in ((True, True), (True, False), (False, False)):
        got = TE.ate_rmse(gt, est, align=align, scale=scale)
        want = JE.ate_rmse(gt, est, align=align, scale=scale)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    for delta in (1, 3):
        got = TE.rpe_rmse(gt, est, delta=delta)
        want = JE.rpe_rmse(gt, est, delta=delta)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert TE.ate_rmse(gt, gt)["rmse"] < 1e-9
    res = TE.main_ape([str(gt), str(est), "-as", "--rpe", "2"])
    assert res["rmse"] == pytest.approx(
        JE.main_ape([str(gt), str(est), "-as", "--rpe", "2"])["rmse"])
    # EuRoC's csv layout: nanoseconds and w-first quaternions
    csv = tmp_path / "data.csv"
    with open(csv, "w") as f:
        f.write("#timestamp,x,y,z,qw,qx,qy,qz\n")
        for t, p, q in zip(ts, pts, qs):
            f.write(",".join(str(v) for v in
                             [int(t * 1e9), *p, q[3], q[0], q[1], q[2]])
                    + "\n")
    for a, b in zip(TE.load_tum_traj(csv), JE.load_tum_traj(csv)):
        np.testing.assert_array_equal(a, b)

