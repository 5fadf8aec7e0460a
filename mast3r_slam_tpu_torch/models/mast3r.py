"""MASt3R two-view transformer in PyTorch.

Counterpart of ``mast3r_slam_tpu/models/mast3r.py``: ViT-L encoder (16x16
patchify, 24 pre-LN blocks with 2D RoPE), the dual cross-decoder run as one
stacked two-stream chain, DPT + catMLP heads and the postprocess. Parameters
are nested dicts of tensors with the JAX pytree's structure and layouts, so
``models/convert.py::params_from_jax`` carries JAX weights over unchanged.

Every attention goes through :func:`attention_rope` → kernel K1
(:func:`attention`, kernel K3 without RoPE, has no call site); every
stride-1 3x3 conv of the DPT heads through ``layers.conv2d`` → kernel K2.

Precision: f32 matmuls and convs run in true f32. :func:`init_params` and
``convert.params_from_jax`` set ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` to False (see
:func:`use_full_f32`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mast3r_slam_tpu_torch.models import layers as L
from mast3r_slam_tpu_torch.ops import flash_attention as FA


def use_full_f32():
    """f32 matmuls and cuDNN convs in true f32 (no TF32) process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class MASt3RConfig:
    # ViT-Large encoder / base decoder — the released MASt3R checkpoint.
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: int = 4
    rope_base: float = 100.0
    desc_dim: int = 24
    two_confs: bool = True
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128
    dpt_layer_dims: tuple = (96, 192, 384, 768)
    dtype: str = "bfloat16"        # transformer trunk compute dtype
    head_dtype: str = "float32"    # DPT + catMLP head intermediates

    @property
    def dpt_hooks(self):
        d = self.dec_depth
        return (0, d * 2 // 4, d * 3 // 4, d)

    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def head_compute_dtype(self):
        return (torch.bfloat16 if self.head_dtype == "bfloat16"
                else torch.float32)


def tiny_config(**kw) -> MASt3RConfig:
    """A small config for tests (same topology, tiny dims)."""
    defaults = dict(
        enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
        dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
        dpt_feature_dim=32, dpt_last_dim=16, dpt_layer_dims=(8, 12, 16, 24),
        desc_dim=8, dtype="float32",
    )
    defaults.update(kw)
    return MASt3RConfig(**defaults)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_rope(q, k, v, qtabs, ktabs):
    """RoPE + attention: ``q/k/v (B, H, N, D)`` un-rotated; ``qtabs/ktabs``
    the ``(cos, sin)`` tables of the q and k positions
    (``FA.rope_tables``). Always the fused kernel path (K1 on CUDA, its
    plain version on CPU). The JAX package passes positions and lets XLA
    share the tables across a program; here the encoder and the decoder
    build them once per pass and hand them to every block."""
    return FA.flash_attention_rope(q, k, v, *qtabs, *ktabs)


def attention(q, k, v):
    """Softmax attention without RoPE: ``q (B, H, Nq, D)``, ``k, v (B, H,
    Nk, D)``. On CUDA tensors it launches kernel K3 at any shape the kernel
    takes (D = 64, any Nq and Nk); on CPU tensors it returns K3's plain
    version. The JAX ``attention`` chose between the Pallas kernel and XLA by
    ``b·h >= 32``, a single-block config and Nq, Nk multiples of 128: that
    was tuning for the TPU grid and is not ported. No model call site uses
    it; every attention of the model is :func:`attention_rope`."""
    return FA.flash_attention(q, k, v)


def _split_heads(x, n_heads):
    b, n, d = x.shape
    return x.reshape(b, n, n_heads, d // n_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def self_attn(p, x, tabs, n_heads):
    q, k, v = L.linear(p["qkv"], x).chunk(3, dim=-1)
    q, k, v = (_split_heads(t, n_heads) for t in (q, k, v))
    out = _merge_heads(attention_rope(q, k, v, tabs, tabs))
    return L.linear(p["proj"], out)


def encoder_block(p, x, tabs, n_heads):
    x = x + self_attn(p["attn"], L.layernorm(p["norm1"], x), tabs, n_heads)
    return x + L.mlp(p["mlp"], L.layernorm(p["norm2"], x))


# ---------------------------------------------------------------------------
# Stacked dual decoder: both streams as one (2, B, N, C) chain over (2, ...)
# weight stacks, so each sublayer is ONE attention call for both streams.
# ---------------------------------------------------------------------------


def _linear_s(p, x):
    """Per-stream linear: ``x (2, B, N, C)``, ``w (2, C, D)``; one batched
    product with the bias fused (``baddbmm``)."""
    s, b, n, c = x.shape
    w = p["w"].to(x.dtype)
    x2 = x.reshape(s, b * n, c)
    if "b" in p:
        y = torch.baddbmm(p["b"].to(x.dtype)[:, None, :], x2, w)
    else:
        y = torch.bmm(x2, w)
    return y.reshape(s, b, n, w.shape[-1])


def _layernorm_s(p, x, eps=1e-6):
    """Per-stream LayerNorm: f32 moments, per-stream (2, C) affine."""
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=eps)
    y = y * p["g"][:, None, None, :] + p["b"][:, None, None, :]
    return y.to(x.dtype)


def _mlp_s(p, x):
    return _linear_s(p["fc2"], L.gelu(_linear_s(p["fc1"], x)))


def _heads_s(x, n_heads):
    """(2, B, N, D) → (2B, H, N, Dh) head layout (un-rotated)."""
    s, b, n, d = x.shape
    return _split_heads(x.reshape(s * b, n, d), n_heads)


def self_attn_s(p, x, xtabs, n_heads):
    s, b, n, d = x.shape
    q, k, v = _linear_s(p["qkv"], x).chunk(3, dim=-1)
    q, k, v = (_heads_s(t, n_heads) for t in (q, k, v))
    out = _merge_heads(attention_rope(q, k, v, xtabs, xtabs))
    return _linear_s(p["proj"], out.reshape(s, b, n, d))


def cross_attn_s(p, x, mem, xtabs, mtabs, n_heads):
    s, b, n, d = x.shape
    q = _heads_s(_linear_s(p["q"], x), n_heads)
    k = _heads_s(_linear_s(p["k"], mem), n_heads)
    v = _heads_s(_linear_s(p["v"], mem), n_heads)
    out = _merge_heads(attention_rope(q, k, v, xtabs, mtabs))
    return _linear_s(p["proj"], out.reshape(s, b, n, d))


def decoder_block_s(p, x, mem, xtabs, mtabs, n_heads):
    """One block of both streams; ``xtabs/mtabs`` are the RoPE tables of
    the stream and memory positions, flattened to (2B, N, D)."""
    x = x + self_attn_s(p["attn"], _layernorm_s(p["norm1"], x), xtabs,
                        n_heads)
    mem_n = _layernorm_s(p["norm_y"], mem)
    x = x + cross_attn_s(p["cross"], _layernorm_s(p["norm2"], x), mem_n,
                         xtabs, mtabs, n_heads)
    return x + _mlp_s(p["mlp"], _layernorm_s(p["norm3"], x))


def stack_decoder_params(params):
    """``dec_blocks[i]`` + ``dec_blocks2[i]`` leaves stacked into (2, ...)."""
    def stack(a, b):
        if isinstance(a, dict):
            return {k: stack(a[k], b[k]) for k in a}
        return torch.stack([a, b])

    return [stack(b1, b2)
            for b1, b2 in zip(params["dec_blocks"], params["dec_blocks2"])]


def prepare_params(params, cfg: MASt3RConfig):
    """Load-time prep: compute-dtype weight cast + the stacked decoder
    (``dec_stacked``); the per-stream decoder lists are dropped."""
    p = cast_params_for_compute(params, cfg)
    p["dec_stacked"] = stack_decoder_params(p)
    del p["dec_blocks"], p["dec_blocks2"]
    return p


def head_params(params, which):
    """Per-head parameters: 0 = head1 (view 1 / self), 1 = head2."""
    return params["head1" if which == 0 else "head2"]


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def _init_attn(g, dim, dev):
    return {"qkv": L.init_linear(g, dim, 3 * dim, dev),
            "proj": L.init_linear(g, dim, dim, dev)}


def _init_cross(g, dim, dev):
    return {k: L.init_linear(g, dim, dim, dev)
            for k in ("q", "k", "v", "proj")}


def _init_mlp(g, dim, hidden, dev, out=None):
    return {"fc1": L.init_linear(g, dim, hidden, dev),
            "fc2": L.init_linear(g, hidden, out or dim, dev)}


def _init_enc_block(g, dim, mlp_ratio, dev):
    return {
        "norm1": L.init_layernorm(dim, dev),
        "attn": _init_attn(g, dim, dev),
        "norm2": L.init_layernorm(dim, dev),
        "mlp": _init_mlp(g, dim, dim * mlp_ratio, dev),
    }


def _init_dec_block(g, dim, mlp_ratio, dev):
    return {
        "norm1": L.init_layernorm(dim, dev),
        "attn": _init_attn(g, dim, dev),
        "norm2": L.init_layernorm(dim, dev),
        "norm_y": L.init_layernorm(dim, dev),
        "cross": _init_cross(g, dim, dev),
        "norm3": L.init_layernorm(dim, dev),
        "mlp": _init_mlp(g, dim, dim * mlp_ratio, dev),
    }


def _init_dpt(g, cfg: MASt3RConfig, num_channels, dev):
    ld = cfg.dpt_layer_dims
    fd = cfg.dpt_feature_dim
    hook_dims = (cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3
    p = {
        "act0_conv": L.init_conv(g, 1, 1, hook_dims[0], ld[0], dev),
        "act0_up": L.init_conv(g, 4, 4, ld[0], ld[0], dev),
        "act1_conv": L.init_conv(g, 1, 1, hook_dims[1], ld[1], dev),
        "act1_up": L.init_conv(g, 2, 2, ld[1], ld[1], dev),
        "act2_conv": L.init_conv(g, 1, 1, hook_dims[2], ld[2], dev),
        "act3_conv": L.init_conv(g, 1, 1, hook_dims[3], ld[3], dev),
        "act3_down": L.init_conv(g, 3, 3, ld[3], ld[3], dev),
    }
    for i in range(4):
        p[f"rn{i}"] = L.init_conv(g, 3, 3, ld[i], fd, dev, bias=False)
    for i in range(1, 5):
        p[f"ref{i}"] = {
            k: L.init_conv(g, 3, 3, fd, fd, dev)
            for k in ("rcu1_c1", "rcu1_c2", "rcu2_c1", "rcu2_c2")}
        p[f"ref{i}"]["out"] = L.init_conv(g, 1, 1, fd, fd, dev)
    p["head_c1"] = L.init_conv(g, 3, 3, fd, fd // 2, dev)
    p["head_c2"] = L.init_conv(g, 3, 3, fd // 2, cfg.dpt_last_dim, dev)
    p["head_c3"] = L.init_conv(g, 1, 1, cfg.dpt_last_dim, num_channels, dev)
    # random-init runs only: damp the regression output so postprocess()'s
    # expm1(|xyz|) gives O(1) pointmaps instead of ~1e8 ones that overflow
    # the f32 Sim(3) tracking solve
    p["head_c3"]["w"] *= 0.05
    return p


def init_params(cfg: MASt3RConfig, seed: int = 0, device="cuda"):
    """Random-init parameter tree (shapes match the converted checkpoint),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    use_full_f32()
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = {
        "patch_embed": L.init_conv(g, cfg.patch_size, cfg.patch_size, 3,
                                   cfg.enc_embed_dim, dev),
        "enc_blocks": [_init_enc_block(g, cfg.enc_embed_dim, cfg.mlp_ratio,
                                       dev) for _ in range(cfg.enc_depth)],
        "enc_norm": L.init_layernorm(cfg.enc_embed_dim, dev),
        "decoder_embed": L.init_linear(g, cfg.enc_embed_dim,
                                       cfg.dec_embed_dim, dev),
        "dec_blocks": [_init_dec_block(g, cfg.dec_embed_dim, cfg.mlp_ratio,
                                       dev) for _ in range(cfg.dec_depth)],
        "dec_blocks2": [_init_dec_block(g, cfg.dec_embed_dim, cfg.mlp_ratio,
                                        dev) for _ in range(cfg.dec_depth)],
        "dec_norm": L.init_layernorm(cfg.dec_embed_dim, dev),
    }
    idim = cfg.enc_embed_dim + cfg.dec_embed_dim
    out_feats = (cfg.desc_dim + int(cfg.two_confs)) * cfg.patch_size ** 2
    for h in ("head1", "head2"):
        params[h] = {
            "dpt": _init_dpt(g, cfg, 4, dev),
            "local_feat": _init_mlp(g, idim, 4 * idim, dev, out=out_feats),
        }
        # same damping: desc_conf is exp(x), and O(10) random logits would
        # overflow the f32 tracking/matching solves
        params[h]["local_feat"]["fc2"]["w"] *= 0.05
    return params


def cast_params_for_compute(params, cfg: MASt3RConfig):
    """Pre-cast matmul/conv weights to their compute dtype once: the trunk
    follows ``cfg.dtype``, the heads ``cfg.head_dtype``; LayerNorm scales and
    biases stay f32 (they take part in f32 math)."""
    trunk_dt = cfg.compute_dtype()
    head_dt = cfg.head_compute_dtype()

    def cast(tree, dt):
        return tree_map(lambda a: a.to(dt), tree)

    def cast_block(blk, dt):
        out = dict(blk)
        for k in ("attn", "cross", "mlp"):
            if k in out:
                out[k] = cast(out[k], dt)
        return out

    p = dict(params)
    if trunk_dt != torch.float32:
        p["patch_embed"] = cast(p["patch_embed"], trunk_dt)
        p["decoder_embed"] = cast(p["decoder_embed"], trunk_dt)
        for key in ("enc_blocks", "dec_blocks", "dec_blocks2"):
            p[key] = [cast_block(b, trunk_dt) for b in p[key]]
    if head_dt != torch.float32:
        for h in ("head1", "head2"):
            p[h] = cast(p[h], head_dt)
    return p


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def patch_positions(hp, wp, batch, device):
    """Integer (y, x) coordinates of an hp x wp patch grid → (B, N, 2)."""
    yy, xx = torch.meshgrid(torch.arange(hp, device=device),
                            torch.arange(wp, device=device), indexing="ij")
    pos = torch.stack([yy, xx], dim=-1).reshape(1, hp * wp, 2)
    return pos.expand(batch, hp * wp, 2).to(torch.int32)


def encode_image(params, cfg: MASt3RConfig, img):
    """``img (B, H, W, 3)`` (ImgNorm'd to [-1, 1]) → (feat (B, N, C) f32,
    pos (B, N, 2))."""
    dt = cfg.compute_dtype()
    b, h, w, _ = img.shape
    x = L.conv2d(params["patch_embed"], img.to(dt), stride=cfg.patch_size,
                 padding="VALID")
    hp, wp = h // cfg.patch_size, w // cfg.patch_size
    x = x.reshape(b, hp * wp, cfg.enc_embed_dim)
    pos = patch_positions(hp, wp, b, img.device)
    tabs = FA.rope_tables(pos, cfg.enc_embed_dim // cfg.enc_num_heads,
                          cfg.rope_base)
    for blk in params["enc_blocks"]:
        x = encoder_block(blk, x, tabs, cfg.enc_num_heads)
    x = L.layernorm(params["enc_norm"], x)
    return x.float(), pos


def decode_pair(params, cfg: MASt3RConfig, feat1, pos1, feat2, pos2):
    """Dual decoder as one stacked two-stream chain over
    ``params["dec_stacked"]`` (from :func:`prepare_params`); returns
    per-stream hook activations (f32): entry 0 is the encoder output, later
    entries the decoder blocks at the hook depths, the last one
    LayerNorm'd."""
    dt = cfg.compute_dtype()
    hooks = set(cfg.dpt_hooks)
    depth = cfg.dec_depth
    f1 = L.linear(params["decoder_embed"], feat1.to(dt))
    f2 = L.linear(params["decoder_embed"], feat2.to(dt))
    out1, out2 = [feat1], [feat2]
    x = torch.stack([f1, f2])                        # (2, B, N, C)
    hd = cfg.dec_embed_dim // cfg.dec_num_heads
    xtabs = FA.rope_tables(torch.cat([pos1, pos2]), hd, cfg.rope_base)
    mtabs = FA.rope_tables(torch.cat([pos2, pos1]), hd, cfg.rope_base)
    for i, blk in enumerate(params["dec_stacked"]):
        x = decoder_block_s(blk, x, x.flip(0), xtabs, mtabs,
                            cfg.dec_num_heads)
        if (i + 1) == depth:
            norm = {k: torch.stack([params["dec_norm"][k]] * 2)
                    for k in ("g", "b")}
            xn = _layernorm_s(norm, x).float()
            out1.append(xn[0])
            out2.append(xn[1])
        elif (i + 1) in hooks:
            out1.append(x[0].float())
            out2.append(x[1].float())
    return out1, out2


def _residual_conv_unit(p1, p2, x):
    y = L.conv2d(p1, F.relu(x))
    y = L.conv2d(p2, F.relu(y))
    return x + y


def _fusion_block(p, x, skip=None):
    if skip is not None:
        x = x + _residual_conv_unit(p["rcu1_c1"], p["rcu1_c2"], skip)
    x = _residual_conv_unit(p["rcu2_c1"], p["rcu2_c2"], x)
    b, h, w, c = x.shape
    x = L.interpolate_bilinear(x, (2 * h, 2 * w), align_corners=True)
    return L.conv2d(p["out"], x)


def dpt_head(p, hook_feats, img_hw, patch_size):
    """DPT multi-scale fusion over the 4 hook activations → (B, H, W, 4)."""
    H, W = img_hw
    nh, nw = H // patch_size, W // patch_size
    t0, t1, t2, t3 = [t.reshape(t.shape[0], nh, nw, t.shape[-1])
                      for t in hook_feats]
    l0 = L.conv2d_transpose(p["act0_up"], L.conv2d(p["act0_conv"], t0), 4)
    l1 = L.conv2d_transpose(p["act1_up"], L.conv2d(p["act1_conv"], t1), 2)
    l2 = L.conv2d(p["act2_conv"], t2)
    # stride-2 3x3 with explicit (1, 1) padding, as torch's DPT
    l3 = L.conv2d(p["act3_down"], L.conv2d(p["act3_conv"], t3), stride=2,
                  padding=[(1, 1), (1, 1)])
    l0 = L.conv2d(p["rn0"], l0)
    l1 = L.conv2d(p["rn1"], l1)
    l2 = L.conv2d(p["rn2"], l2)
    l3 = L.conv2d(p["rn3"], l3)
    path4 = _fusion_block(p["ref4"], l3)[:, :l2.shape[1], :l2.shape[2]]
    path3 = _fusion_block(p["ref3"], path4, l2)
    path2 = _fusion_block(p["ref2"], path3, l1)
    path1 = _fusion_block(p["ref1"], path2, l0)
    x = L.conv2d(p["head_c1"], path1)
    b, h, w, c = x.shape
    x = L.interpolate_bilinear(x, (2 * h, 2 * w), align_corners=True)
    x = F.relu(L.conv2d(p["head_c2"], x))
    return L.conv2d(p["head_c3"], x)


def downstream_head(p, cfg: MASt3RConfig, dec_out, img_hw):
    """Per-view head: DPT pts3d+conf, MLP descriptors, postprocess. Returns
    ``pts3d (B,H,W,3)``, ``conf (B,H,W)``, ``desc (B,H,W,D)``,
    ``desc_conf (B,H,W)``."""
    H, W = img_hw
    ps = cfg.patch_size
    hd = cfg.head_compute_dtype()
    dec_h = [t.to(hd) for t in dec_out]
    raw = dpt_head(p["dpt"], dec_h, img_hw, ps).float()
    cat = torch.cat([dec_h[0], dec_h[-1]], dim=-1)
    local = L.mlp(p["local_feat"], cat)
    b = local.shape[0]
    local = local.reshape(b, H // ps, W // ps, -1)
    local = L.pixel_shuffle(local, ps).float()
    return postprocess(torch.cat([raw, local], dim=-1), cfg.desc_dim,
                       cfg.two_confs)


def postprocess(fmap, desc_dim, two_confs):
    """Exp-mode depth, conf = 1 + exp, desc_conf = exp, L2-normalized
    descriptors."""
    xyz = fmap[..., 0:3]
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    pts3d = xyz / d.clamp_min(1e-8) * torch.expm1(d)
    conf = 1.0 + torch.exp(fmap[..., 3].clamp(-50.0, 50.0))
    desc = fmap[..., 4:4 + desc_dim]
    desc = desc / torch.linalg.norm(desc, dim=-1, keepdim=True).clamp_min(
        1e-8)
    if two_confs:
        desc_conf = torch.exp(fmap[..., 4 + desc_dim].clamp(-50.0, 50.0))
    else:
        desc_conf = conf
    return {"pts3d": pts3d, "conf": conf, "desc": desc,
            "desc_conf": desc_conf}


def downstream_heads(params, cfg: MASt3RConfig, d1, d2, img_hw):
    """Both per-view heads for a decoded pair → (res1, res2)."""
    return (downstream_head(params["head1"], cfg, d1, img_hw),
            downstream_head(params["head2"], cfg, d2, img_hw))


def decode_heads(params, cfg: MASt3RConfig, feat1, pos1, feat2, pos2,
                 img_hw):
    """Decoder + both heads for an (i, j) feature pair → (res1, res2)."""
    d1, d2 = decode_pair(params, cfg, feat1, pos1, feat2, pos2)
    return downstream_heads(params, cfg, d1, d2, img_hw)


# The JAX package's jitted name for the encoder pass.
encode = encode_image


def two_view_infer(params, cfg: MASt3RConfig, img1, img2):
    """Encode both images and decode the pair once → (res1, res2) in view
    1's frame: the asymmetric inference of frame-to-keyframe tracking.
    ``params`` come from :func:`prepare_params`."""
    feat1, pos1 = encode(params, cfg, img1)
    feat2, pos2 = encode(params, cfg, img2)
    img_hw = (img1.shape[1], img1.shape[2])
    return decode_heads(params, cfg, feat1, pos1, feat2, pos2, img_hw)
