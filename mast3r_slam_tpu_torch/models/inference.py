"""SLAM-facing MASt3R inference (counterpart of
``mast3r_slam_tpu/models/inference.py``): mono inference for keyframe
initialization, the asymmetric frame↔keyframe decode, and the backend's
symmetric pair decode and match entry points. Both decode directions of B
keyframe pairs run as one decoder call of batch 2B; the matcher then runs
each direction as its own B = 1 call, as the JAX package's single-device
path does. On a card, :meth:`MASt3RInference.match_symmetric` and
:meth:`~MASt3RInference.match_oneway` run decode, heads and matcher as
one CUDA graph per batch size and static configuration
(``ops/graphs.py``; the JAX package's ``_match_symmetric_fused`` /
``_match_oneway_fused`` jits), each matcher call a conditional loop node;
a missing matcher init is the identity, as in JAX, so a warm and a cold
start share one graph. With a backend mesh (``parallel/``) the pair batch
is padded to a multiple of the mesh size and each slot decodes its share
on its own device (K1 and K2 on every backend device), on a card as a
CUDA graph per device and per-slot batch (the JAX package's jitted
``_decode_symmetric_batch_jit``); the matcher runs on the first slot's
device, where the decode outputs gather, as one graph per B there (the
JAX mesh path's one batched ``matching.match``, whose stages are jitted).
"""

from __future__ import annotations

import torch

from mast3r_slam_tpu_torch.models import mast3r as M
from mast3r_slam_tpu_torch.ops import matching
from mast3r_slam_tpu_torch.ops.graphs import GraphCache
from mast3r_slam_tpu_torch.parallel import sharding as S


def _decimate(a, ds, h_axis=1):
    """Strided spatial decimation of image-shaped head outputs (the
    working-resolution ``downsample``); ``h_axis`` is the H axis, W the
    next one."""
    if ds <= 1:
        return a
    idx = [slice(None)] * a.ndim
    idx[h_axis] = slice(None, None, ds)
    idx[h_axis + 1] = slice(None, None, ds)
    return a[tuple(idx)]


def _mono_core(params, cfg, img, img_hw, ds=1):
    """Encode + self-pair decode + head1 → (feat, pos, X (B, N, 3),
    C (B, N, 1))."""
    feat, pos = M.encode_image(params, cfg, img)
    d1, _ = M.decode_pair(params, cfg, feat, pos, feat, pos)
    res1 = M.downstream_head(M.head_params(params, 0), cfg, d1, img_hw)
    pts = _decimate(res1["pts3d"], ds)
    conf = _decimate(res1["conf"], ds)
    b, h, w, _ = pts.shape
    return feat, pos, pts.reshape(b, h * w, 3), conf.reshape(b, h * w, 1)


def _decode_symmetric_core(params, cfg, feat_i, pos_i, feat_j, pos_j,
                           img_hw, ds=1):
    """``(B, Np, C)`` features → stacked ``[ii, ji, jj, ij]`` head outputs
    (leading dim 4, then B) from one decoder call of batch 2B."""
    f1 = torch.cat([feat_i, feat_j])      # sources
    f2 = torch.cat([feat_j, feat_i])      # cross streams
    p1 = torch.cat([pos_i, pos_j])
    p2 = torch.cat([pos_j, pos_i])
    res1, res2 = M.decode_heads(params, cfg, f1, p1, f2, p2, tuple(img_hw))
    b = feat_i.shape[0]

    def stack(key):
        a1, a2 = res1[key], res2[key]     # [ii; jj], [ji; ij]
        return _decimate(torch.stack([a1[:b], a2[:b], a1[b:], a2[b:]]), ds,
                         h_axis=2)

    return (stack("pts3d"), stack("conf"), stack("desc"),
            stack("desc_conf"))


def _match_rows(X, D, init, kw):
    """Both matcher directions of the ``[ii, ji, jj, ij]`` decode outputs,
    one B = 1 ``matching.match`` call per row of ``[i2j (B); j2i (B)]``
    (``init (2B, N)``). Returns ``(idx (2B, N), valid (2B, N, 1))``."""
    X11 = torch.cat([X[0], X[2]])
    X21 = torch.cat([X[1], X[3]])
    D11 = torch.cat([D[0], D[2]])
    D21 = torch.cat([D[1], D[3]])
    rows = [matching.match(X11[r:r + 1], X21[r:r + 1], D11[r:r + 1],
                           D21[r:r + 1], idx_1_to_2_init=init[r:r + 1],
                           **kw)
            for r in range(X11.shape[0])]
    return (torch.cat([r[0] for r in rows]),
            torch.cat([r[1] for r in rows]))


def _match_symmetric_core(params, cfg, feat_i, pos_i, feat_j, pos_j, init,
                          img_hw, ds, kw):
    """Symmetric decode + heads + both matcher directions (the JAX
    ``_match_symmetric_fused``). Returns ``(idx (2B, N), valid (2B, N, 1),
    Q)``, ``Q`` the stacked ``[ii, ji, jj, ij]`` descriptor
    confidences."""
    X, _, D, Q = _decode_symmetric_core(params, cfg, feat_i, pos_i, feat_j,
                                        pos_j, img_hw, ds)
    idx, valid = _match_rows(X, D, init, kw)
    return idx, valid, Q


def _match_oneway_core(params, cfg, feat_i, pos_i, feat_j, pos_j, init,
                       img_hw, ds, kw):
    """Decode (i, j) + heads + the i→j matcher (the JAX
    ``_match_oneway_fused``). Returns ``(idx_i2j, valid_j, Qii, Qji)``."""
    res_ii, res_ji = M.decode_heads(params, cfg, feat_i, pos_i, feat_j,
                                    pos_j, tuple(img_hw))
    Xii, Xji, Dii, Dji, Qii, Qji = (
        _decimate(r[k], ds) for r, k in (
            (res_ii, "pts3d"), (res_ji, "pts3d"), (res_ii, "desc"),
            (res_ji, "desc"), (res_ii, "desc_conf"), (res_ji, "desc_conf")))
    b, h, w, _ = Xii.shape
    idx, valid = matching.match(Xii, Xji, Dii, Dji, idx_1_to_2_init=init,
                                **kw)
    return idx, valid, Qii.reshape(b, h * w), Qji.reshape(b, h * w)


class MASt3RInference:
    """Holds prepared params + config and exposes the SLAM-facing inference
    methods. ``params`` should come from ``M.prepare_params``;
    ``match_cfg`` is the config's ``matching`` section (the backend
    matcher's settings); ``mesh`` (a ``parallel.sharding.DeviceMesh``)
    shards the symmetric pair decode over the backend's devices (see
    :meth:`set_mesh`); ``downsample`` (``dataset.img_downsample``)
    decimates the working pointmaps, while the model still sees the full
    crop. On a card the backend's decode + match run as CUDA graphs
    (``graphed=False`` runs them eagerly there: a comparison's
    reference)."""

    def __init__(self, params, cfg: M.MASt3RConfig, match_cfg=None,
                 mesh=None, downsample: int = 1, graphed=True):
        self.params = params
        self.cfg = cfg
        self.match_cfg = match_cfg or {}
        self.ds = int(downsample)
        # match_symmetric's and match_oneway's CUDA graphs, one per key
        self.graphs = GraphCache("match") if graphed else None
        self.set_mesh(mesh)

    def set_mesh(self, mesh):
        """Decode symmetric pair batches over ``mesh``, or on ``params``'
        own device when None. The mesh gets a parameter replica per
        distinct device; ``params`` stay where they are (the frontend's
        copy), and a mesh device that holds them already shares them."""
        self.mesh = mesh
        self.params_mesh = (None if mesh is None
                            else S.replicate(self.params, mesh))
        # the sharded decode's CUDA graphs, one cache per distinct device:
        # a cache forgets its graphs when its owner changes, and each
        # card's replica is an owner of its own
        self.slot_graphs = {}

    def encode_frame(self, frame):
        """Populate ``frame.feat`` / ``frame.pos`` (cached across calls)."""
        if frame.feat is None:
            frame.feat, frame.pos = M.encode_image(self.params, self.cfg,
                                                   frame.img[None])
        return frame.feat, frame.pos

    def inference_mono(self, frame):
        """Self-pair decode → flattened (Xii (1, N, 3), Cii (1, N, 1)); also
        populates ``frame.feat`` / ``frame.pos``."""
        feat, pos, X, C = _mono_core(self.params, self.cfg, frame.img[None],
                                     tuple(frame.img_true_shape), self.ds)
        frame.feat, frame.pos = feat, pos
        return X, C

    def asymmetric_inference(self, frame_i, frame_j):
        """One decode pass i↔j. Returns stacked (X, C, D, Q) with leading
        dim 2: index 0 = view i in frame i, index 1 = view j in frame i."""
        feat_i, pos_i = self.encode_frame(frame_i)
        feat_j, pos_j = self.encode_frame(frame_j)
        res_ii, res_ji = M.decode_heads(self.params, self.cfg, feat_i, pos_i,
                                        feat_j, pos_j,
                                        tuple(frame_i.img_true_shape))
        out = [torch.cat([res_ii[k], res_ji[k]], dim=0)
               for k in ("pts3d", "conf", "desc", "desc_conf")]
        return tuple(_decimate(a, self.ds) for a in out)

    def match_asymmetric(self, frame_i, frame_j, idx_i2j_init=None):
        """Frame-to-keyframe decode and match. Returns ``(idx_i2j,
        valid_match_j, Xii, Cii, Qii, Xji, Cji, Qji)`` with the pointmaps
        flattened to (1, N, ...)."""
        X, C, D, Q = self.asymmetric_inference(frame_i, frame_j)
        h, w = X.shape[1:3]
        idx_i2j, valid_match_j = matching.match(
            X[:1], X[1:], D[:1], D[1:], idx_1_to_2_init=idx_i2j_init,
            **self._match_kw())
        Xf, Cf, Qf = (a.reshape(2, h * w, -1) for a in (X, C, Q))
        return (idx_i2j, valid_match_j,
                Xf[0][None], Cf[0][None], Qf[0][None],
                Xf[1][None], Cf[1][None], Qf[1][None])

    def decode_symmetric_batch(self, feat_i, pos_i, feat_j, pos_j, img_hw):
        """Both decode directions of B pairs in one batched call. Returns
        (X, C, D, Q), each with leading dim 4 over [ii, ji, jj, ij] and
        second dim B.

        With a mesh, B is padded up to a multiple of the mesh size (the
        last pair repeated; the JAX package's edge-mode pad), each slot
        decodes its pairs on its device with that device's replica, and
        the outputs gather on the first slot's device in slot order,
        trimmed back to B: the decode never runs on the frontend's copy.
        On a card each slot's decode is the graph of its device and
        per-slot batch (:meth:`_slot_decode`)."""
        if self.mesh is None:
            return _decode_symmetric_core(self.params, self.cfg, feat_i,
                                          pos_i, feat_j, pos_j, img_hw,
                                          self.ds)
        mesh = self.mesh
        b = feat_i.shape[0]
        pad = S.pad_to_multiple(b, mesh.size) - b
        shards = []
        for t in (feat_i, pos_i, feat_j, pos_j):
            if pad:
                t = torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
            shards.append(S.shard_leading(t, mesh))
        outs = [self._slot_decode(p, parts, img_hw)
                for p, parts in zip(self.params_mesh, zip(*shards))]
        return tuple(torch.cat([o[k].to(mesh.first) for o in outs],
                               dim=1)[:, :b] for k in range(4))

    def _slot_decode(self, params, parts, img_hw):
        """One slot's decode of its pairs ``parts`` with its device's
        parameter replica ``params``: on a card the graph of this device,
        image size and per-slot batch, in the device's own cache (kept
        until the next :meth:`set_mesh`), else eagerly."""
        def run(*args):
            return _decode_symmetric_core(params, self.cfg, *args,
                                          tuple(img_hw), self.ds)

        dev = parts[0].device
        if self.graphs is None or dev.type != "cuda":
            return run(*parts)
        cache = self.slot_graphs.setdefault(dev, GraphCache("decode"))
        key = ("decode", self.cfg, tuple(img_hw), self.ds)
        return cache.run(key, run, parts, owner=params)

    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j, img_hw,
                        init_i2j=None, init_j2i=None):
        """Symmetric matching of B keyframe pairs (backend edge creation).

        Returns ``(idx_i2j, idx_j2i, valid_j, valid_i, Qii, Qjj, Qji,
        Qij)``, the Q's ``(B, N, 1)``. Matcher inits, like its outputs, are
        indexed by image-2 pixels and hold image-1 pixels: ``init_i2j``
        maps j-pixels to i-pixels (e.g. keyframe j's points projected into
        camera i), and vice versa; a missing one starts from identity.
        Without a mesh, one program (on a card, a CUDA graph per B);
        with one, the sharded decode, then the matcher (on a card, a CUDA
        graph per B on the first slot's device)."""
        b = feat_i.shape[0]
        n = (img_hw[0] // self.ds) * (img_hw[1] // self.ds)
        kw = self._match_kw()
        if self.mesh is None:
            init = self._init(b, n, feat_i.device, init_i2j, init_j2i)

            def run(*args):
                return _match_symmetric_core(self.params, self.cfg, *args,
                                             tuple(img_hw), self.ds, kw)

            idx, valid, Q = self._graphed(
                "symmetric", img_hw, kw, run,
                (feat_i, pos_i, feat_j, pos_j, init))
        else:
            X, _, D, Q = self.decode_symmetric_batch(feat_i, pos_i, feat_j,
                                                     pos_j, img_hw)
            # the warm starts come from the frontend's keyframe state: the
            # matcher runs where the decode outputs are
            init = self._init(b, n, X.device, init_i2j, init_j2i)

            def rows(X, D, init):
                return _match_rows(X, D, init, kw)

            idx, valid = self._graphed("rows", img_hw, kw, rows,
                                       (X, D, init))
        Qii, Qji, Qjj, Qij = (Q[k].reshape(b, n, 1) for k in range(4))
        return (idx[:b], idx[b:], valid[:b], valid[b:], Qii, Qjj, Qji, Qij)

    def match_oneway(self, feat_i, pos_i, feat_j, pos_j, img_hw,
                     init_i2j=None):
        """One direction of a symmetric edge: decode (i, j) and the i→j
        matcher, as one program (on a card, a CUDA graph). The backend
        uses it when the j→i direction of a consecutive edge is the
        tracker's own decode and match (the same computation on the same
        features). Returns ``(idx_i2j (1, N), valid_j (1, N, 1), Qii
        (1, N), Qji (1, N))``."""
        b = feat_i.shape[0]
        n = (img_hw[0] // self.ds) * (img_hw[1] // self.ds)
        init = self._init(b, n, feat_i.device, init_i2j)
        kw = self._match_kw()

        def run(*args):
            return _match_oneway_core(self.params, self.cfg, *args,
                                      tuple(img_hw), self.ds, kw)

        return self._graphed("oneway", img_hw, kw, run,
                             (feat_i, pos_i, feat_j, pos_j, init))

    @staticmethod
    def _init(b, n, device, *inits):
        """The matcher inits of each direction given, stacked ``(len(inits)
        B, N)`` long on ``device``; identity rows for a missing one."""
        ident = torch.arange(n, device=device).expand(b, n)
        return torch.cat([ident if i is None else i.to(device).long()
                          for i in inits])

    def _graphed(self, kind, img_hw, kw, run, args):
        """``run(*args)``: on a card as the graph of this kind, image size,
        decimation and matcher settings (the inputs' shapes and the
        params complete the key), else eagerly."""
        if self.graphs is None or args[0].device.type != "cuda":
            return run(*args)
        key = (kind, self.cfg, tuple(img_hw), self.ds,
               tuple(sorted(kw.items())))
        return self.graphs.run(key, run, args, owner=self.params)

    def _match_kw(self):
        c = self.match_cfg
        return dict(
            max_iter=int(c.get("max_iter", 10)),
            lambda_init=float(c.get("lambda_init", 1e-8)),
            convergence_thresh=float(c.get("convergence_thresh", 1e-6)),
            dist_thresh=float(c.get("dist_thresh", 0.1)),
            radius=int(c.get("radius", 3)),
            dilation_max=int(c.get("dilation_max", 5)),
            refine_mode=matching.resolve_refine_mode(c),
            plateau_frac=float(c.get("plateau_frac", 0.001)),
            level_step=int(c.get("level_step", 1)),
            proj_step=int(c.get("proj_step", 1)),
        )
