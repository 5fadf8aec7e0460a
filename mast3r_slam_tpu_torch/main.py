"""MASt3R-SLAM on PyTorch/CUDA — the command-line entry point.

    python -m mast3r_slam_tpu_torch.main --dataset <path> \\
        --config config/base.yaml [--no-viz] \\
        [--calib intrinsics.yaml] [--save-as default] [--weights <.npz>] \\
        [--retrieval-weights <.pth|.npz>] [--retrieval-codebook <.pkl|.npy|.npz>] \\
        [--max-frames N] [--checkpoint state.npz] [--resume state.npz] \\
        [--profile]

Counterpart of the repository's ``main.py`` with the same flags: the
INIT / TRACKING / RELOC frontend loop, the backend (retrieval, factor
growth, global BA) inline (``single_thread: true``) or as a thread, the
services as threads (the quality service, the local TSDF refiner and the
global TSDF, each as the config turns it on), the shutdown drain,
checkpoint / resume, and the export (trajectory, PLYs with the quality
fields, keyframe PNGs). It runs on the CUDA card; :func:`main` takes
``device="cpu"`` from Python (the tests), and there is no CPU fallback.
With several cards it lays the roles out as the JAX CLI does
(``parallel/topology.py``: tracking on the first card, the backend's
decode and BA sharded over a power-of-two set of the others, the services
on the rest); from Python, ``devices`` gives that layout a slot list of
its own, e.g. five slots of one card or eight of the CPU.

Without ``--no-viz`` the viewer (``viz/viewer.py``) runs as a thread: an
OpenGL window through glfw, or surfaceless EGL without a display. Where no
GL stack imports (PyOpenGL, and glfw or EGL), it prints ``[viewer]
disabled (...)`` and the run goes on without it, as the JAX viewer does.
"""

from __future__ import annotations

import argparse
import time

import torch

from mast3r_slam_tpu_torch import evaluation
from mast3r_slam_tpu_torch.data.datasets import Intrinsics, load_dataset
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import mast3r as M
from mast3r_slam_tpu_torch.models.inference import MASt3RInference
from mast3r_slam_tpu_torch.ops import lie
from mast3r_slam_tpu_torch.parallel.topology import plan_topology
from mast3r_slam_tpu_torch.services.quality_async import (
    AsynchronousQualityService)
from mast3r_slam_tpu_torch.services.tsdf_global import TSDFGlobalManager
from mast3r_slam_tpu_torch.services.tsdf_local import TSDFRefiner
from mast3r_slam_tpu_torch.slam.factor_graph import FactorGraph
from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer, Mode, States
from mast3r_slam_tpu_torch.slam.pipeline import Backend, create_frame
from mast3r_slam_tpu_torch.slam.retrieval import RetrievalDatabase
from mast3r_slam_tpu_torch.slam.tracker import FrameTracker
from mast3r_slam_tpu_torch.utils import tictoc
from mast3r_slam_tpu_torch.utils.checkpoint import load_state, save_state
from mast3r_slam_tpu_torch.utils.config import load_config, read_yaml
from mast3r_slam_tpu_torch.viz.viewer import Viewer


# how long the shutdown waits for the viewer thread to draw its last frame
# and release its GL context
VIEWER_JOIN_S = 10.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--config", default="config/base.yaml")
    ap.add_argument("--save-as", default="default")
    ap.add_argument("--no-viz", action="store_true")
    ap.add_argument("--calib", default="")
    ap.add_argument("--weights", default="",
                    help="model weights: a .npz parameter file")
    ap.add_argument("--retrieval-weights", default="",
                    help="retrieval head: reference .pth checkpoint or a "
                         "parameter .npz")
    ap.add_argument("--retrieval-codebook", default="",
                    help="ASMK codebook: reference .pkl, .npy, or .npz "
                         "(omit to bootstrap online from early keyframes)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="write a SLAM-state snapshot here at shutdown")
    ap.add_argument("--resume", default="",
                    help="resume from a SLAM-state snapshot")
    ap.add_argument("--profile", action="store_true",
                    help="per-section timing report at exit (utils.tictoc)")
    return ap.parse_args(argv)


def model_config(cfg) -> M.MASt3RConfig:
    mdl = cfg.get("model", {})
    if mdl.get("preset", "") == "tiny":
        return M.tiny_config()
    return M.MASt3RConfig(dtype=mdl.get("dtype", "bfloat16"),
                          head_dtype=mdl.get("head_dtype", "bfloat16"))


def build_model(cfg, weights="", downsample=1, device="cuda", mesh=None):
    """The model the CLI runs: ``model.preset: tiny`` or the full MASt3R
    config (trunk / head dtypes from the config), with ``weights`` (a
    parameter ``.npz``) or random weights from seed 0, on ``device`` and
    with its pair decode sharded over ``mesh`` when one is given."""
    mcfg = model_config(cfg)
    if weights:
        params = convert.params_from_jax(convert.load_npz(weights), mcfg,
                                         device)
        print(f"loaded converted weights: {weights}")
    else:
        print("WARNING: no --weights given; using random-init parameters "
              "(geometry will be meaningless — fine for perf/smoke runs)")
        params = M.init_params(mcfg, seed=0, device=device)
    return MASt3RInference(M.prepare_params(params, mcfg), mcfg,
                           cfg.get("matching", {}), mesh=mesh,
                           downsample=downsample)


def _check_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: the port's CLI runs on the card (from Python, "
            "main(argv, device='cpu') runs the plain versions)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        # a bare "cuda" is the calling thread's device: name it
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_slots(device, devices=None):
    """The slot list the topology is planned on: ``devices`` when given;
    on the card, every visible card with ``device`` first; on the CPU,
    ``[device]``."""
    if devices is not None:
        return [_check_device(d) for d in devices]
    device = _check_device(device)
    if device.type == "cpu":
        return [device]
    return [device] + [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())
                       if i != device.index]


def main(argv=None, device="cuda", model=None, devices=None):
    """Run the CLI. ``device`` is ``"cuda"`` (the card) or ``"cpu"``;
    ``devices`` (a list of devices, repeats allowed) is the slot list the
    disjoint topology is planned on instead of the visible cards (its
    first slot is the frontend's); ``model`` (a ``MASt3RInference``)
    replaces :func:`build_model` and is placed on the run's backend mesh.
    Returns a summary dict (keyframes, graph, frames processed, the
    per-frame mode sequence, the services, the topology, the viewer or
    None)."""
    args = parse_args(argv)
    topo = plan_topology(device_slots(device, devices))
    device = topo.frontend_device
    mesh = topo.backend_mesh
    cfg = load_config(args.config)
    single_thread = bool(cfg.get("single_thread", False))

    dataset = load_dataset(args.dataset, cfg)
    if args.calib:
        c = read_yaml(args.calib)
        dataset.set_calibration(Intrinsics(
            c["width"], c["height"], c["fx"], c["fy"], c["cx"], c["cy"],
            (c.get("k1", 0), c.get("k2", 0), c.get("p1", 0), c.get("p2", 0),
             c.get("k3", 0)), cfg=cfg))
        cfg["use_calib"] = True
    use_calib = bool(cfg.get("use_calib", False)) and dataset.has_calib()

    img_size = int(cfg.get("dataset", {}).get("img_size", 512))
    (h, w), _ = dataset.get_img_shape(img_size)
    # dataset.img_downsample decimates the working per-pixel state; the
    # model still runs at the full (h, w) crop
    ds = int(cfg.get("dataset", {}).get("img_downsample", 1))
    if ds > 1 and ((h // ds) % 16 or (w // ds) % 16):
        raise SystemExit(
            f"dataset.img_downsample={ds} must keep the working resolution "
            f"({h}//{ds}, {w}//{ds}) divisible by the 16px quality patch")
    h_work, w_work = h // ds, w // ds
    n_frames = len(dataset)
    if args.max_frames:
        n_frames = min(n_frames, args.max_frames)
    print(f"dataset: {args.dataset} ({n_frames} frames @ {h}x{w}; "
          f"calib={'on' if use_calib else 'off'}; device {device})")
    if mesh is not None:
        print(f"disjoint device topology: {topo.describe()}")

    # remove this run's stale outputs first, so a crash cannot leave a mix
    if getattr(dataset, "save_results", True):
        stale_dir, seq_name = evaluation.prepare_savedir(args.save_as, dataset)
        for stale in (f"{seq_name}.txt", f"{seq_name}.ply",
                      f"{seq_name}_quality.ply"):
            p = stale_dir / stale
            if p.exists():
                p.unlink()

    if model is None:
        model = build_model(cfg, args.weights, downsample=ds, device=device,
                            mesh=mesh)
    elif model.ds != ds:
        raise ValueError(f"the model decimates by {model.ds}, the config "
                         f"asks for dataset.img_downsample={ds}")
    else:
        model.set_mesh(mesh)
    keyframes = KeyframeBuffer(h_work, w_work, capacity=110,
                               feat_dim=model.cfg.enc_embed_dim,
                               device=device, model_hw=(h, w))
    states = States()
    K = None
    if use_calib:
        K = torch.as_tensor(dataset.camera_intrinsics.K_frame,
                            device=device)
        if ds > 1:
            K = K * torch.tensor([[1.0 / ds], [1.0 / ds], [1.0]],
                                 device=device)
        keyframes.set_intrinsics(K)

    # each service on its planned device (the frontend's on one device)
    quality = (AsynchronousQualityService(
                   cfg, device=topo.quality_device or device).start()
               if cfg.get("quality", {}).get("enabled", True) else None)
    tracker = FrameTracker(model, keyframes, cfg, quality_service=quality)
    refiner = TSDFRefiner(keyframes, cfg, quality_service=quality,
                          device=topo.tsdf_local_device or device).start()
    graph = FactorGraph(model, keyframes, cfg, K=K, mesh=mesh,
                        home_device=None if mesh is None else device)
    head_params, nfeat = None, 256
    if args.retrieval_weights:
        if args.retrieval_weights.endswith(".npz"):
            head_params = convert.retrieval_head_from_jax(
                convert.load_npz(args.retrieval_weights))
        else:
            head_params, nfeat = convert.load_retrieval_checkpoint(
                args.retrieval_weights)
        print(f"loaded retrieval head: {args.retrieval_weights}")
    retrieval = RetrievalDatabase(cfg, desc_dim=model.cfg.enc_embed_dim,
                                  nfeat=nfeat, head_params=head_params)
    if args.retrieval_codebook:
        retrieval.set_codebook(convert.load_retrieval_codebook(
            args.retrieval_codebook))
        print(f"loaded retrieval codebook: {args.retrieval_codebook} "
              f"({retrieval.codebook.shape[0]} words)")
    tsdf_manager = TSDFGlobalManager(keyframes, cfg).start()
    backend = Backend(model, keyframes, states, graph, retrieval, cfg,
                      tsdf_manager=tsdf_manager)
    if not single_thread:
        backend.start()

    viewer = None
    if not args.no_viz:
        viewer = Viewer(keyframes, states, cfg)
        viewer.start()

    # ---------------- frontend loop ---------------------------------------
    i = 0
    fps_t0, fps_i0 = time.time(), 0
    last_T = lie.identity(device=device)
    modes: list[str] = []
    if args.resume:
        i = load_state(args.resume, keyframes, graph)
        if len(keyframes):
            last_T = keyframes.T_WC[len(keyframes) - 1].clone()
            states.set_mode(Mode.TRACKING)
        # rebuild the retrieval index from the restored keyframes' features
        for kf_i in range(len(keyframes)):
            retrieval.update(keyframes[kf_i], add_after_query=True, k=0,
                             kf_idx=kf_i)
        print(f"resumed from {args.resume}: {len(keyframes)} keyframes "
              f"(re-indexed for retrieval), frame {i}")
    try:
        while i < n_frames:
            while states.paused:
                time.sleep(0.05)
            mode = states.get_mode()
            if mode == Mode.TERMINATED:
                break
            modes.append(mode.name)
            _, img = dataset[i]
            frame = create_frame(i, img, T_WC=last_T, img_size=img_size,
                                 downsample=ds, device=device)

            if mode == Mode.INIT:
                X, C = model.inference_mono(frame)
                frame.update_pointmap(X[0], C[0])
                keyframes.append(frame)
                states.queue_global_optimization(len(keyframes) - 1)
                states.set_mode(Mode.TRACKING)
                states.set_frame(frame)
                i += 1
                continue

            add_new_kf = False
            if mode == Mode.TRACKING:
                if args.profile:
                    with tictoc.section("tracker.track", sync_device=True):
                        add_new_kf, _, try_reloc = tracker.track(frame)
                else:
                    add_new_kf, _, try_reloc = tracker.track(frame)
                if try_reloc:
                    states.set_mode(Mode.RELOC)
                states.set_frame(frame)
                last_T = frame.T_WC
            else:  # RELOC
                X, C = model.inference_mono(frame)
                frame.update_pointmap(X[0], C[0])
                states.set_frame(frame)
                states.queue_reloc()
                if single_thread:
                    while states.reloc_sem > 0:
                        backend.step()

            if mode == Mode.TRACKING and add_new_kf:
                keyframes.append(frame)
                new_idx = len(keyframes) - 1
                if tracker.last_kf_match is not None:
                    prev_kf, idx_f2k, vmatch, Qk = tracker.last_kf_match
                    states.set_kf_match_hint(prev_kf, new_idx, idx_f2k[0],
                                             vmatch, Qk)
                    tracker.last_kf_match = None
                states.queue_global_optimization(new_idx)
                if refiner.is_alive():  # health gate
                    refiner.maybe_schedule_sliding_window(new_idx)

            if single_thread:
                while not backend.idle():
                    if not backend.step():
                        break

            i += 1
            if i % 30 == 0:
                dt = time.time() - fps_t0
                rs = refiner.stats
                print(f"frame {i}/{n_frames}  FPS "
                      f"{(i - fps_i0) / max(dt, 1e-9):5.2f}  "
                      f"kfs {len(keyframes)}  edges {graph.n_edges()}  "
                      f"tsdf ok/rej {rs['refined_blocks']}/"
                      f"{rs['rejected_blocks']}")
                fps_t0, fps_i0 = time.time(), i
    except KeyboardInterrupt:
        print("interrupted")

    # ---------------- shutdown: drain the backend ----------------------------
    states.set_mode(Mode.TERMINATED)
    if not single_thread:
        t0 = time.time()
        while (not backend.idle() and backend.error is None
               and time.time() - t0 < 60):
            time.sleep(0.1)
        backend.stop()
        if backend.error is not None:
            raise RuntimeError("the backend thread failed") from backend.error
    tcfg = cfg.get("tsdf_refine", {})
    refiner.schedule_final_pass(len(keyframes) - 1)
    refiner.drain(max_wait_s=float(tcfg.get("max_shutdown_wait_s", 60)),
                  min_wait_s=float(tcfg.get("min_shutdown_wait_s", 2)))
    refiner.print_stats()
    tsdf_manager.shutdown()
    if quality:
        quality.shutdown()
    if viewer is not None:
        viewer.should_close.set()
        viewer.join(timeout=VIEWER_JOIN_S)

    if args.checkpoint:
        save_state(args.checkpoint, keyframes, graph, frame_idx=i)
        print(f"checkpoint → {args.checkpoint}")

    # ---------------- save results -------------------------------------------
    if getattr(dataset, "save_results", True):
        savedir, seq_name = evaluation.prepare_savedir(args.save_as, dataset)
        traj = evaluation.save_traj(savedir, f"{seq_name}.txt",
                                    dataset.timestamps, keyframes)
        evaluation.save_reconstruction(savedir, f"{seq_name}.ply", keyframes,
                                       conf_threshold=0.0)
        evaluation.save_ply_with_quality(savedir, f"{seq_name}_quality.ply",
                                         keyframes, quality)
        evaluation.save_keyframes(savedir, dataset.timestamps, keyframes)
        print(f"saved results → {savedir} (traj: {traj})")
    if args.profile:
        tictoc.report()
    print("done")
    return {"keyframes": keyframes, "graph": graph, "frames_processed": i,
            "tracker": tracker, "modes": modes, "states": states,
            "retrieval": retrieval,
            "quality": quality, "refiner": refiner,
            "tsdf_manager": tsdf_manager, "topo": topo, "viewer": viewer}


if __name__ == "__main__":
    main()
