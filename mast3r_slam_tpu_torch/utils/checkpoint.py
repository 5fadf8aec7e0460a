"""SLAM-state checkpoint / resume (counterpart of
``mast3r_slam_tpu/utils/checkpoint.py``, same ``.npz`` keys).

The keyframe buffer (poses, pointmaps, confidences, encoder features,
counters, display and model images), the factor graph's edges and matches,
and the frame counter go into one compressed ``.npz``, so a run can resume
(``--checkpoint`` / ``--resume``) or a map be reloaded for export. Derived
state is rebuilt rather than saved: the retrieval inverted file (the CLI
re-indexes the restored keyframes) and the measured-channel cache (dropped
on restore).

Tensors are written as float32 / int: a bfloat16 tensor is widened to
float32 (exact) and cast back to the buffer's type on load, so no reader
needs a bfloat16 numpy type.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    if torch.is_tensor(t):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _into(dst: torch.Tensor, src) -> torch.Tensor:
    return torch.as_tensor(np.asarray(src)).to(dst.device, dst.dtype)


def save_state(path, keyframes, factor_graph=None, frame_idx: int = 0):
    """Snapshot the keyframe buffer (+ optional factor graph) to ``path``."""
    with keyframes.lock:
        n = len(keyframes)
        data = {
            "n_size": np.asarray(n),
            "frame_idx": np.asarray(frame_idx),
            "h": np.asarray(keyframes.h),
            "w": np.asarray(keyframes.w),
            "dataset_idx": keyframes.dataset_idx[:n],
            "T_WC": _np(keyframes.T_WC[:n]),
            "X": _np(keyframes.X[:n]),
            "C": _np(keyframes.C[:n]),
            "N": keyframes.N[:n],
            "N_updates": keyframes.N_updates[:n],
            "feat": _np(keyframes.feat[:n]),
            "pos": _np(keyframes.pos[:n]),
            "version": keyframes.version[:n],
        }
        if keyframes.K is not None:
            data["K"] = _np(keyframes.K)
        uimgs = [keyframes.uimg[i] for i in range(n)]
        if n and all(u is not None for u in uimgs):
            data["uimg"] = np.stack([np.asarray(u) for u in uimgs])
        imgs = [keyframes.img[i] for i in range(n)]
        if n and all(im is not None for im in imgs):
            data["img"] = np.stack([_np(im) for im in imgs])
    if factor_graph is not None:
        data["edges_ii"] = factor_graph.ii
        data["edges_jj"] = factor_graph.jj
        for key in ("idx_ii2jj", "idx_jj2ii", "valid_match_j",
                    "valid_match_i", "Q_ii2jj", "Q_jj2ii"):
            data[key] = _np(getattr(factor_graph, key))
    np.savez_compressed(path, **data)
    return path


def load_state(path, keyframes, factor_graph=None) -> int:
    """Restore into an already-constructed keyframe buffer (+ factor
    graph). Returns the frame index to resume from."""
    z = np.load(path, allow_pickle=False)
    n = int(z["n_size"])
    if int(z["h"]) != keyframes.h or int(z["w"]) != keyframes.w:
        raise ValueError("checkpoint resolution mismatch")
    with keyframes.lock:
        keyframes.n_size = n
        keyframes.dataset_idx[:n] = z["dataset_idx"]
        for key in ("T_WC", "X", "C", "feat", "pos"):
            buf = getattr(keyframes, key)
            buf[:n] = _into(buf, z[key])
        keyframes.N[:n] = z["N"]
        keyframes.N_updates[:n] = z["N_updates"]
        keyframes.version[:n] = z["version"]
        # the pointmaps were replaced: bump the content version of every
        # restored slot so no cache keyed on it serves pre-restore channels
        keyframes.xc_version[:n] += 1
        if "K" in z:
            keyframes.K = torch.as_tensor(z["K"], device=keyframes.device)
        img_dtype = torch.float32
        for i in range(n):
            if "uimg" in z:
                keyframes.uimg[i] = z["uimg"][i]
            if "img" in z:
                keyframes.img[i] = torch.as_tensor(
                    z["img"][i], device=keyframes.device).to(img_dtype)
            # (working shape, model-crop shape): add_factors reads [1]
            keyframes.img_shapes[i] = ((keyframes.h, keyframes.w),
                                       tuple(keyframes.model_hw))
            keyframes.frame_id_to_index[int(z["dataset_idx"][i])] = i
            keyframes.is_dirty[i] = True
    if factor_graph is not None:
        # unconditionally: the restored pointmaps invalidate any channels
        factor_graph.drop_meas_cache()
    if factor_graph is not None and "edges_ii" in z:
        factor_graph.ii = z["edges_ii"]
        factor_graph.jj = z["edges_jj"]
        for key in ("idx_ii2jj", "idx_jj2ii", "valid_match_j",
                    "valid_match_i", "Q_ii2jj", "Q_jj2ii"):
            buf = getattr(factor_graph, key)
            setattr(factor_graph, key, _into(buf, z[key]))
    return int(z["frame_idx"])
