"""Weight conversion and carry.

- :func:`convert_state_dict` / :func:`load_checkpoint`: the reference MASt3R
  PyTorch checkpoint (``state_dict`` of the released ``.pth``) → the
  parameter tree of numpy arrays, in the JAX package's layouts (``(in,
  out)`` linears, HWIO convs and transposed convs), as
  ``mast3r_slam_tpu/models/convert.py`` builds it; :func:`params_from_tree`
  moves such a tree to torch.
- :func:`convert_retrieval_state_dict` / :func:`load_retrieval_checkpoint`
  / :func:`load_retrieval_codebook`: the retrieval head and the ASMK
  codebook.
- :func:`params_from_jax` / :func:`retrieval_head_from_jax`: the JAX
  package's parameter files (``save_params_npz``: a flat ``.npz`` whose keys
  are ``/``-joined tree paths, list indices as components) → the port.

The port keeps the JAX tree's structure and layouts, so no array is
reshaped when it is carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from mast3r_slam_tpu_torch.models import mast3r as M


# ---------------------------------------------------------------------------
# Flat npz files
# ---------------------------------------------------------------------------

def load_npz(path) -> dict[str, np.ndarray]:
    """Flat ``{path: array}`` dict from a parameter ``.npz``."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _unflatten(flat):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def params_from_tree(tree, cfg: M.MASt3RConfig, device="cuda"):
    """Parameter tree of arrays → the port's tree of f32 tensors on
    ``device``; checks the depths and widths against ``cfg``."""
    M.use_full_f32()
    params = M.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(device), tree)
    checks = {
        "enc_blocks": (len(params["enc_blocks"]), cfg.enc_depth),
        "dec_blocks": (len(params["dec_blocks"]), cfg.dec_depth),
        "enc width": (params["enc_norm"]["g"].shape[0], cfg.enc_embed_dim),
        "dec width": (params["dec_norm"]["g"].shape[0], cfg.dec_embed_dim),
        "patch": (params["patch_embed"]["w"].shape[0], cfg.patch_size),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad:
        raise ValueError(f"parameters do not match the config: {bad}")
    return params


def params_from_jax(flat: dict, cfg: M.MASt3RConfig, device="cuda"):
    """JAX parameter pytree (flattened as ``save_params_npz`` writes it) →
    the port's parameter tree of f32 tensors on ``device``."""
    return params_from_tree(_unflatten(flat), cfg, device)


def retrieval_head_from_jax(flat: dict) -> dict:
    """A retrieval head saved by the JAX package's ``save_params_npz``
    (whitening, projector layers, the ``residual`` flag as a 0-d bool) →
    the ``head_params`` dict ``RetrievalDatabase`` takes (numpy arrays and
    a Python bool)."""
    head = _unflatten(flat)
    if "residual" in head:
        head["residual"] = bool(np.asarray(head["residual"]))
    return head


# ---------------------------------------------------------------------------
# The reference MASt3R checkpoint
# ---------------------------------------------------------------------------

def _lin(sd, prefix):
    p = {"w": np.ascontiguousarray(sd[prefix + ".weight"].T)}
    if prefix + ".bias" in sd:
        p["b"] = np.asarray(sd[prefix + ".bias"])
    return p


def _conv(sd, prefix):
    p = {"w": np.ascontiguousarray(
        np.transpose(sd[prefix + ".weight"], (2, 3, 1, 0)))}
    if prefix + ".bias" in sd:
        p["b"] = np.asarray(sd[prefix + ".bias"])
    return p


def _convT(sd, prefix):
    # ConvTranspose2d weight (in, out, kh, kw) → (kh, kw, in, out)
    p = {"w": np.ascontiguousarray(
        np.transpose(sd[prefix + ".weight"], (2, 3, 0, 1)))}
    if prefix + ".bias" in sd:
        p["b"] = np.asarray(sd[prefix + ".bias"])
    return p


def _ln(sd, prefix):
    return {"g": np.asarray(sd[prefix + ".weight"]),
            "b": np.asarray(sd[prefix + ".bias"])}


def _enc_block(sd, pre):
    return {
        "norm1": _ln(sd, pre + ".norm1"),
        "attn": {"qkv": _lin(sd, pre + ".attn.qkv"),
                 "proj": _lin(sd, pre + ".attn.proj")},
        "norm2": _ln(sd, pre + ".norm2"),
        "mlp": {"fc1": _lin(sd, pre + ".mlp.fc1"),
                "fc2": _lin(sd, pre + ".mlp.fc2")},
    }


def _dec_block(sd, pre):
    return {
        "norm1": _ln(sd, pre + ".norm1"),
        "attn": {"qkv": _lin(sd, pre + ".attn.qkv"),
                 "proj": _lin(sd, pre + ".attn.proj")},
        "norm2": _ln(sd, pre + ".norm2"),
        "norm_y": _ln(sd, pre + ".norm_y"),
        "cross": {
            "q": _lin(sd, pre + ".cross_attn.projq"),
            "k": _lin(sd, pre + ".cross_attn.projk"),
            "v": _lin(sd, pre + ".cross_attn.projv"),
            "proj": _lin(sd, pre + ".cross_attn.proj"),
        },
        "norm3": _ln(sd, pre + ".norm3"),
        "mlp": {"fc1": _lin(sd, pre + ".mlp.fc1"),
                "fc2": _lin(sd, pre + ".mlp.fc2")},
    }


def _dpt(sd, pre):
    p = {
        "act0_conv": _conv(sd, pre + ".act_postprocess.0.0"),
        "act0_up": _convT(sd, pre + ".act_postprocess.0.1"),
        "act1_conv": _conv(sd, pre + ".act_postprocess.1.0"),
        "act1_up": _convT(sd, pre + ".act_postprocess.1.1"),
        "act2_conv": _conv(sd, pre + ".act_postprocess.2.0"),
        "act3_conv": _conv(sd, pre + ".act_postprocess.3.0"),
        "act3_down": _conv(sd, pre + ".act_postprocess.3.1"),
        "head_c1": _conv(sd, pre + ".head.0"),
        "head_c2": _conv(sd, pre + ".head.2"),
        "head_c3": _conv(sd, pre + ".head.4"),
    }
    for i in range(4):
        p[f"rn{i}"] = _conv(sd, pre + f".scratch.layer{i + 1}_rn")
    for i in range(1, 5):
        rpre = pre + f".scratch.refinenet{i}"
        p[f"ref{i}"] = {
            "rcu1_c1": _conv(sd, rpre + ".resConfUnit1.conv1"),
            "rcu1_c2": _conv(sd, rpre + ".resConfUnit1.conv2"),
            "rcu2_c1": _conv(sd, rpre + ".resConfUnit2.conv1"),
            "rcu2_c2": _conv(sd, rpre + ".resConfUnit2.conv2"),
            "out": _conv(sd, rpre + ".out_conv"),
        }
    return p


# checkpoint keys with no inference weight: croco's masked-pretraining
# token, and DPT's duplicate registrations of the layer{i+1}_rn modules
_KNOWN_UNUSED = ("mask_token", ".dpt.scratch.layer_rn.")


class _TrackingDict(dict):
    """Records key reads, so a conversion can report dropped weights."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return dict.__getitem__(self, k)

    def __contains__(self, k):
        self.read.add(k)
        return dict.__contains__(self, k)


def convert_state_dict(sd, enc_depth=24, dec_depth=12, unused_out=None):
    """Reference state dict (name → array-like) → parameter tree of numpy
    arrays. ``unused_out`` (a list) receives the checkpoint keys no
    parameter consumed, beyond the known inference-irrelevant ones."""
    sd = _TrackingDict({k: np.asarray(v) for k, v in sd.items()})
    # a checkpoint without dec_blocks2 shares the first decoder's weights
    if not any(k.startswith("dec_blocks2") for k in sd):
        for k in list(sd):
            if k.startswith("dec_blocks."):
                sd[k.replace("dec_blocks.", "dec_blocks2.", 1)] = sd[k]
    params = {
        "patch_embed": _conv(sd, "patch_embed.proj"),
        "enc_blocks": [_enc_block(sd, f"enc_blocks.{i}")
                       for i in range(enc_depth)],
        "enc_norm": _ln(sd, "enc_norm"),
        "decoder_embed": _lin(sd, "decoder_embed"),
        "dec_blocks": [_dec_block(sd, f"dec_blocks.{i}")
                       for i in range(dec_depth)],
        "dec_blocks2": [_dec_block(sd, f"dec_blocks2.{i}")
                        for i in range(dec_depth)],
        "dec_norm": _ln(sd, "dec_norm"),
    }
    for n in (1, 2):
        params[f"head{n}"] = {
            "dpt": _dpt(sd, f"downstream_head{n}.dpt"),
            "local_feat": {
                "fc1": _lin(sd,
                            f"downstream_head{n}.head_local_features.fc1"),
                "fc2": _lin(sd,
                            f"downstream_head{n}.head_local_features.fc2"),
            },
        }
    if unused_out is not None:
        unused_out.extend(sorted(
            k for k in set(sd) - sd.read
            if not any(pat in k for pat in _KNOWN_UNUSED)))
    return params


def checkpoint_depths(sd):
    """(encoder depth, decoder depth) of a reference state dict: the
    number of ``enc_blocks.<i>.`` and ``dec_blocks.<i>.`` blocks."""
    def depth(prefix):
        return len({k.split(".")[1] for k in sd if k.startswith(prefix)})

    return depth("enc_blocks."), depth("dec_blocks.")


def load_checkpoint(path, enc_depth=None, dec_depth=None):
    """Reference ``.pth`` checkpoint → parameter tree of numpy arrays (move
    it to the card with :func:`params_from_tree`); the depths default to
    the checkpoint's own (24 and 12 for the released MASt3R)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    sd = {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    enc, dec = checkpoint_depths(sd)
    return convert_state_dict(sd, enc_depth or enc, dec_depth or dec)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_npz(tree, path):
    """A parameter tree of arrays as the flat ``.npz`` that
    :func:`load_npz` reads (keys are ``/``-joined tree paths, list indices
    as components: the JAX package's ``save_params_npz`` layout)."""
    np.savez(path, **_flatten(tree))


# ---------------------------------------------------------------------------
# Retrieval head and codebook
# ---------------------------------------------------------------------------

def convert_retrieval_state_dict(sd, *, residual=False, dim=1024):
    """Retrieval-head checkpoint → ``head_params`` for
    ``slam/retrieval.py::select_local_features``: whiteners ``m``, ``P``
    (``x' = (x - m) @ P``; identity when absent), the projector's Linear
    (``w (in, out)``, ``b``) and LayerNorm (``g``, ``b``) layers with a
    GELU marker after each LayerNorm, and ``residual`` (from the
    checkpoint's args)."""
    sd = {k: np.asarray(v) for k, v in sd.items()
          if not k.startswith("backbone")}

    def whiten(prefix, d):
        if f"{prefix}.m" not in sd:
            return np.zeros((d,), np.float32), np.eye(d, dtype=np.float32)
        m = sd[f"{prefix}.m"].reshape(-1).astype(np.float32)
        P = sd[f"{prefix}.p"].astype(np.float32)
        return m, P

    proj_idx = sorted({int(k.split(".")[1]) for k in sd
                       if k.startswith("projector.")
                       and k.endswith(".weight")})
    projector = []
    for i in proj_idx:
        W = sd[f"projector.{i}.weight"]
        if W.ndim == 2:
            projector.append({
                "w": np.ascontiguousarray(W.T.astype(np.float32)),
                "b": sd.get(f"projector.{i}.bias",
                            np.zeros(W.shape[0])).astype(np.float32),
            })
            dim = W.shape[0]
        else:
            projector.append({
                "g": W.astype(np.float32),
                "b": sd[f"projector.{i}.bias"].astype(np.float32),
            })
            projector.append({"gelu": np.zeros((0,), np.float32)})

    in_dim = (projector[0]["w"].shape[0] if projector
              and "w" in projector[0] else dim)
    pre_m, pre_P = whiten("prewhiten", in_dim)
    post_m, post_P = whiten("postwhiten", dim)
    return {
        "prewhiten_m": pre_m, "prewhiten_P": pre_P,
        "postwhiten_m": post_m, "postwhiten_P": post_P,
        "projector": projector,
        "residual": bool(residual),
    }


def load_retrieval_checkpoint(path):
    """Reference retrieval checkpoint (``.pth``) → ``(head_params,
    nfeat)``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    sd = {k: v.double().numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}
    args = ckpt.get("args")
    residual = bool(getattr(args, "residual", False)) if args else False
    nfeat = int(getattr(args, "nfeat", 300)) if args else 300
    return convert_retrieval_state_dict(sd, residual=residual), nfeat


def load_retrieval_codebook(path):
    """ASMK codebook → centroid array ``(K, D)``: the reference's pickled
    ``Codebook.state_dict()`` (``{"state": {"centroids": ...}}``), a pickled
    array, or ``.npy`` / ``.npz`` (key ``centroids``, else the first)."""
    p = str(path)
    if p.endswith(".npy"):
        return np.load(p)
    if p.endswith(".npz"):
        with np.load(p) as z:
            return z["centroids"] if "centroids" in z.files else z[z.files[0]]
    import pickle

    with open(p, "rb") as fh:
        obj = pickle.load(fh)
    if isinstance(obj, dict) and "state" in obj:
        return np.asarray(obj["state"]["centroids"])
    return np.asarray(obj)
