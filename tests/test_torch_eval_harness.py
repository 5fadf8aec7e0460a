"""The port's accuracy tools on layouts the tests write: the evaluation
harness (``bench/eval_datasets.py``) on a TUM, EuRoC, 7-Scenes, ETH3D and
Replica sequence of four frames each, with ground truth the tests write;
the 7-Scenes ground truth (``data/seven_scenes_gt.py``) against the JAX
repo's ``scripts/make_7scenes_gt.py``, bit for bit on the text; and the
real-weight validation (``bench/validate_real.py``) from a tiny ``.pth``.

The CLI runs on the CPU with tiny tied weights carried from the JAX
package (``torch_parity.tiny_weights``), through an appended ``--config``
that inherits the dataset's own config, as ``tests/test_torch_cli.py`` runs
it; every tracked frame becomes a keyframe, so each trajectory has a row a
frame. The ATE is held against ``evaluation.ate_rmse`` of both packages on
the same two files."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mast3r_slam_tpu import evaluation as JE
from mast3r_slam_tpu.models import convert as JC
from mast3r_slam_tpu.models import mast3r as JM
from mast3r_slam_tpu_torch import evaluation as TE
from mast3r_slam_tpu_torch.bench import eval_datasets as ED
from mast3r_slam_tpu_torch.bench import validate_real as VR
from mast3r_slam_tpu_torch.data import png, seven_scenes_gt
from mast3r_slam_tpu_torch.models import convert as TC
from test_convert import synthetic_torch_state_dict
from torch_parity import tiny_weights, torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
N = 4
HW = (64, 96)               # the uncalibrated layouts' frames
CALIB_HW = (480, 640)       # TUM freiburg1's and 7-Scenes' fixed cameras
STEP = (2.0, 0.7)


def _frames(n, hw, seed=0):
    """Smooth texture panning ``STEP`` pixels a frame (scaled to ``hw``)."""
    rng = np.random.default_rng(seed)
    H, W = hw
    k = W / HW[1]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64) / k
    freqs = rng.uniform(0.05, 0.25, (3, 2))
    phases = rng.uniform(0, 2 * np.pi, 3)
    for i in range(n):
        x, y = xx + STEP[0] * i, yy + STEP[1] * i
        chans = [np.sin(fx * x + fy * y + ph)
                 for (fx, fy), ph in zip(freqs, phases)]
        yield ((0.9 * np.stack(chans, -1) + 1.0) * 127.5).astype(np.uint8)


def _poses(n):
    """Ground truth: (t (n, 3), q (n, 4) xyzw), a gentle arc."""
    i = np.arange(n, dtype=np.float64)
    t = np.stack([0.05 * i, 0.01 * i ** 2, 0.02 * np.sin(i)], -1)
    a = 0.02 * i
    q = np.stack([np.zeros(n), np.sin(a / 2), np.zeros(n), np.cos(a / 2)], -1)
    return t, q


def _write_tum_gt(path, ts):
    t, q = _poses(len(ts))
    path.write_text("# timestamp tx ty tz qx qy qz qw\n" + "".join(
        f"{s:.6f} " + " ".join(f"{v:.9f}" for v in (*t[i], *q[i])) + "\n"
        for i, s in enumerate(ts)))


def _rgb_txt_seq(root, hw, seed=0):
    (root / "rgb").mkdir(parents=True)
    ts = [1e9 + i / 30.0 for i in range(N)]
    for i, img in enumerate(_frames(N, hw, seed)):
        png.write_png(root / "rgb" / f"{i:04d}.png", img)
    (root / "rgb.txt").write_text("# ts file\n" + "".join(
        f"{s:.6f} rgb/{i:04d}.png\n" for i, s in enumerate(ts)))
    _write_tum_gt(root / "groundtruth.txt", [float(f"{s:.6f}") for s in ts])
    return root


def _tum(root):
    return _rgb_txt_seq(root / "rgbd_dataset_freiburg1_desk", CALIB_HW)


def _euroc(root):
    seq = root / "MH_01_easy"
    cam = seq / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    stamps = [1403636579763555584 + i * 50_000_000 for i in range(N)]
    for s, img in zip(stamps, _frames(N, HW, 1)):
        png.write_png(cam / "data" / f"{s}.png", img.mean(-1).astype(np.uint8))
    k = HW[1] / 752
    (cam / "sensor.yaml").write_text(yaml.safe_dump({
        "intrinsics": [458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k],
        "distortion_coefficients": [-0.28340811, 0.07395907, 0.00019359,
                                    1.76187114e-05],
        "resolution": [HW[1], HW[0]]}))
    gt = seq / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    t, q = _poses(N)
    gt.joinpath("data.csv").write_text(
        "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], "
        "q_RS_x [], q_RS_y [], q_RS_z []\n" + "".join(
            f"{s}," + ",".join(f"{v:.9f}" for v in (
                *t[i], q[i, 3], *q[i, :3])) + "\n"
            for i, s in enumerate(stamps)))
    return seq


def _pose_matrix(t, q):
    x, y, z, w = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def _seven_scenes(root):
    scene = root / "chess"
    seq = scene / "seq-01"
    seq.mkdir(parents=True)
    t, q = _poses(N)
    for i, img in enumerate(_frames(N, CALIB_HW, 2)):
        png.write_png(seq / f"frame-{i:06d}.color.png", img)
        np.savetxt(seq / f"frame-{i:06d}.pose.txt", _pose_matrix(t[i], q[i]))
    return scene


def _eth3d(root):
    seq = _rgb_txt_seq(root / "table_3", HW, 3)
    (seq / "calibration.txt").write_text("110.0 110.0 47.5 31.5\n")
    (root / "notes").mkdir()              # no rgb.txt: not a sequence
    return seq


def _replica(root):
    seq = root / "office0"
    (seq / "results").mkdir(parents=True)
    for i, img in enumerate(_frames(N, HW, 4)):
        png.write_png(seq / "results" / f"frame{i:06d}.png", img)
    (seq / "cam_params.json").write_text(
        '{"camera": {"w": 96, "h": 64, "fx": 60.0, "fy": 60.0, '
        '"cx": 47.5, "cy": 31.5}}')
    _write_tum_gt(seq / "traj_tum.txt", [i / 30.0 for i in range(N)])
    return seq


LAYOUTS = {"tum": ("tum", _tum), "euroc": ("euroc", _euroc),
           "7-scenes": ("7-scenes", _seven_scenes),
           "eth3d": ("eth3d", _eth3d), "replica": ("replica", _replica)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tied tiny weights as a JAX npz and a config per dataset that
    inherits the dataset's own: the tiny model at img_size 96, the CLI's
    random-weight cuts, every tracked frame a keyframe, the services off."""
    base = tmp_path_factory.mktemp("eval")
    _, pj, _, _ = tiny_weights(tie_streams=True)
    weights = base / "tiny_tied.npz"
    JC.save_params_npz(pj, weights)
    cfgs = {}
    for name in [*ED.DATASETS, "tum_no_calib"]:
        inherit = ("eval_no_calib.yaml" if name == "tum_no_calib"
                   else ED.DATASETS[name].config)
        path = base / f"{name}.yaml"
        path.write_text(yaml.safe_dump({
            "inherit": str(REPO / "config" / inherit),
            "dataset": {"img_size": 96},
            "model": {"preset": "tiny"},
            "tracking": {"min_match_frac": 0.0, "match_frac_thresh": 1.01,
                         "Q_conf": 0.0},
            "local_opt": {"min_match_frac": 0.0, "Q_conf": 0.0},
            "quality": {"enabled": False},
            "tsdf_refine": {"enabled": False},
            "tsdf_global": {"enabled": False}}))
        cfgs[name] = path
    return base, weights, cfgs


def _same_ate(gt, est, got):
    want = TE.ate_rmse(gt, est, align=True, scale=True)["rmse"]
    want_jax = JE.ate_rmse(str(gt), str(est), align=True, scale=True)["rmse"]
    assert np.isfinite(got) and got == want
    np.testing.assert_allclose(got, want_jax, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dataset", list(LAYOUTS))
def test_harness_on_a_written_layout(setup, dataset, tmp_path, capsys):
    base, weights, cfgs = setup
    root = tmp_path / LAYOUTS[dataset][0]
    seq = LAYOUTS[dataset][1](root).name
    work = tmp_path / "work"
    work.mkdir()
    summary = ED.main([dataset, str(root), "--weights", str(weights),
                       "--workdir", str(work), "--config",
                       str(cfgs[dataset])], device="cpu")
    out = capsys.readouterr().out
    assert list(summary["sequences"]) == [seq]
    others = [s for s in ED.sequences(dataset, root) if s != seq]
    assert summary["skipped"] == others
    for s in others:
        assert f"skip {s} (not found)" in out
    assert f"=== {seq} ===" in out and "APE w.r.t. translation part" in out
    assert summary["save_as"] == ED.DATASETS[dataset].save_as
    rec = summary["sequences"][seq]
    est = work / "logs" / summary["save_as"] / seq / f"{seq}.txt"
    assert Path(rec["traj"]) == est and est.is_file()
    assert rec["frames"] == N and rec["keyframes"] == N
    assert len(est.read_text().splitlines()) == N
    assert rec["pairs"] == N
    assert rec["tracked_ms_median"] > 0 and rec["step_ms_median"] > 0
    want_gt = {"tum": root / seq / "groundtruth.txt",
               "euroc": root / seq / "mav0" / "state_groundtruth_estimate0"
               / "data.csv",
               "7-scenes": work / "groundtruths" / "7-scenes" / f"{seq}.txt",
               "eth3d": root / seq / "groundtruth.txt",
               "replica": root / seq / "traj_tum.txt"}[dataset]
    assert Path(rec["gt"]) == want_gt and want_gt.is_file()
    _same_ate(want_gt, est, rec["ate_rmse"])


def test_tum_no_calib_and_groundtruth_overrides(setup, tmp_path):
    """``--no-calib`` takes eval_no_calib.yaml (TUM only); a ground truth
    under ``<workdir>/groundtruths/`` wins for EuRoC and 7-Scenes, and the
    ETH3D sequences are the subdirectories with an ``rgb.txt``."""
    base, weights, cfgs = setup
    root = tmp_path / "tum"
    seq = _tum(root).name
    summary = ED.main(["tum", str(root), "--no-calib", "--weights",
                       str(weights), "--workdir", str(tmp_path), "--config",
                       str(cfgs["tum_no_calib"])], device="cpu")
    assert summary["config"] == "eval_no_calib.yaml"
    assert summary["sequences"][seq]["frames"] == N
    with pytest.raises(SystemExit):
        ED.main(["euroc", str(root), "--no-calib"], device="cpu")
    for name, sub in (("euroc", "euroc"), ("7-scenes", "7-scenes")):
        gt = tmp_path / "groundtruths" / sub / "X.txt"
        gt.parent.mkdir(parents=True, exist_ok=True)
        gt.write_text("0 0 0 0 0 0 0 1\n")
        assert ED.DATASETS[name].gt(root, "X", tmp_path) == gt
    assert ED.DATASETS["euroc"].gt(root, "Y", tmp_path) == (
        root / "Y" / "mav0" / "state_groundtruth_estimate0" / "data.csv")
    eth = tmp_path / "eth3d"
    _eth3d(eth)
    assert ED.sequences("eth3d", eth) == ["table_3"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rot(axis, angle):
    c, s = np.cos(angle), np.sin(angle)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R = np.eye(3)
    R[i, i] = R[j, j] = c
    R[i, j], R[j, i] = -s, s
    return R


def test_seven_scenes_gt_equals_the_jax_script(tmp_path):
    """Poses whose rotations reach each of Shepperd's four branches (trace
    > 0, then R00, R11 or R22 the largest diagonal entry), plus random
    ones; the port's file equals the script's byte for byte."""
    rng = np.random.default_rng(7)
    rots = [_rot(0, 0.3), _rot(0, 2.9), _rot(1, 2.8), _rot(2, 3.0)]
    for _ in range(6):
        a = rng.normal(size=3)
        rots.append(_rot(0, a[0] * 2) @ _rot(1, a[1] * 2) @ _rot(2, a[2] * 2))
    branches = set()
    for R in rots:
        d = np.diag(R)
        branches.add("trace" if np.trace(R) > 0 else int(np.argmax(d)))
    assert branches == {"trace", 0, 1, 2}
    seq = tmp_path / "heads" / "seq-01"
    seq.mkdir(parents=True)
    for i, R in enumerate(rots):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, rng.normal(size=3)
        np.savetxt(seq / f"frame-{i:06d}.pose.txt", T)
    script = _jax_script("make_7scenes_gt")
    want, got = tmp_path / "want.txt", tmp_path / "got.txt"
    assert script.convert(tmp_path / "heads", want) == len(rots)
    assert seven_scenes_gt.convert(tmp_path / "heads", got) == len(rots)
    assert got.read_bytes() == want.read_bytes()
    for R in rots:
        np.testing.assert_array_equal(seven_scenes_gt.mat_to_quat(R),
                                      script.mat_to_quat(R))
    assert seven_scenes_gt.default_path(tmp_path / "heads") == Path(
        "groundtruths/7-scenes/heads.txt")
    with pytest.raises(FileNotFoundError):
        seven_scenes_gt.convert(tmp_path, tmp_path / "none.txt")


def _assert_same_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_validate_real_from_a_tiny_checkpoint(setup, tmp_path):
    """A tiny ``.pth`` (``{"model": state_dict}``, the reference layouts,
    the second decoder stream and head tied to the first) converts to an ``.npz`` that loads
    to the JAX converter's tree, and the run gives a trajectory and a
    finite ATE on a TUM clip."""
    base, _, cfgs = setup
    cfg = JM.tiny_config()
    # the state dict's layouts at an initialiser's scale (std 0.02 weights,
    # zero biases), where the tied tiny model tracks the clip
    sd = {k: (v * 0.02 if v.ndim > 1 else
              v if k.endswith(".weight") else v * 0.0)
          for k, v in synthetic_torch_state_dict(cfg).items()}
    for k in list(sd):
        for a, b in (("dec_blocks.", "dec_blocks2."),
                     ("downstream_head1.", "downstream_head2.")):
            if k.startswith(a):
                sd[b + k[len(a):]] = sd[k]
    pth = tmp_path / "tiny.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               pth)
    seq = _tum(tmp_path / "tum")
    rec = VR.main([str(pth), str(seq), "--workdir", str(tmp_path),
                   "--config", str(cfgs["tum"])], device="cpu")
    npz = tmp_path / "logs" / "real" / "tiny.npz"
    assert Path(rec["npz"]) == npz
    _assert_same_tree(TC._unflatten(TC.load_npz(npz)),
                      JC.convert_state_dict(sd, cfg.enc_depth,
                                            cfg.dec_depth))
    est = tmp_path / "logs" / VR.SAVE_AS / seq.name / f"{seq.name}.txt"
    assert Path(rec["traj"]) == est and rec["frames"] == N
    assert rec["keyframes"] >= 3
    _same_ate(seq / "groundtruth.txt", est, rec["ate_rmse"])
