"""Loop-closure retrieval: ASMK-style aggregated binarized matching
(counterpart of ``mast3r_slam_tpu/slam/retrieval.py``).

Each keyframe's encoder tokens pass through the retrieval head (whiten →
projector → attention-ranked top-N descriptor selection), are quantized
against a visual-word codebook, aggregated per word and binarized; the
signatures are scored against a host inverted file with a selective
(power-law) hamming kernel, and the top-k past keyframes above a threshold
become loop-closure candidates.

The feature path runs on the keyframe tensors' device with torch ops
(quantization is one matmul + argmax / stable sort, aggregation an
``index_add_``); the codebook is bootstrapped online from the first
keyframes (numpy ``default_rng(0)`` sample + 4 Lloyd steps, as in the JAX
package) unless one is loaded; the inverted file is host numpy (packed
bits, popcount by a uint8 table).

Ties: the JAX package ranks tokens with ``jnp.argsort`` (stable) and takes
the ``ma`` nearest words with ``lax.top_k`` (lower index first on ties);
the port uses ``torch.argsort(..., stable=True)`` for both, so equal values
keep index order as there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Feature path
# ---------------------------------------------------------------------------

def select_local_features(feat, head_params, nfeat, residual=False):
    """Retrieval-head feature prep for one keyframe's tokens ``feat (N, D)``
    → ``(min(nfeat, N), D)`` L2-normalized descriptors.

    With ``head_params``: prewhiten ``(x - m) @ P`` → projector (the layer
    kind is read from its keys: ``w`` linear, ``g`` LayerNorm, else GELU)
    [+ residual] → attention = L2 norm of the projected features →
    postwhiten → top-``nfeat`` by attention. With ``head_params=None``: the
    raw tokens ranked by their norm."""
    x = feat
    if head_params is not None:
        x = (x - head_params["prewhiten_m"]) @ head_params["prewhiten_P"]
        h = x
        for lyr in head_params["projector"]:
            if "w" in lyr:
                h = h @ lyr["w"] + lyr["b"]
            elif "g" in lyr:
                mu = h.mean(dim=-1, keepdim=True)
                var = h.var(dim=-1, unbiased=False, keepdim=True)
                h = (h - mu) * torch.rsqrt(var + 1e-5) * lyr["g"] + lyr["b"]
            else:
                h = F.gelu(h)
        x = h + x if residual else h
        attention = torch.linalg.norm(x, dim=-1)
        x = (x - head_params["postwhiten_m"]) @ head_params["postwhiten_P"]
    else:
        attention = torch.linalg.norm(x, dim=-1)
    top = torch.argsort(-attention, stable=True)[:nfeat]
    sel = x[top]
    return sel / torch.linalg.norm(sel, dim=-1, keepdim=True).clamp_min(1e-8)


def aggregate_binarize(desc, codebook, ma=1):
    """Quantize + per-word aggregate + binarize (the ASMK signature).

    ``desc (M, D)`` L2-normalized, ``codebook (K, D)``; each descriptor goes
    to its ``ma`` nearest words by L2 distance (``argmax(d·c − ‖c‖²/2)``)
    and adds its residual ``desc - c`` there. Returns ``(agg_sign (K, D)
    ±1/0 float, word_mask (K,) bool)``."""
    scores = desc @ codebook.T - 0.5 * (codebook ** 2).sum(dim=-1)[None]
    if ma == 1:
        words = scores.argmax(dim=-1)
    else:
        words = torch.argsort(-scores, dim=-1, stable=True)[:, :ma]
        words = words.reshape(-1)
    resid = desc.repeat_interleave(ma, dim=0) - codebook[words]
    K = codebook.shape[0]
    agg = torch.zeros_like(codebook).index_add_(0, words, resid)
    counts = torch.zeros(K, dtype=torch.int32,
                         device=desc.device).index_add_(
        0, words, torch.ones_like(words, dtype=torch.int32))
    return torch.sign(agg), counts > 0


def lloyd_step(desc, codebook):
    """One k-means (Lloyd) iteration of the codebook."""
    words = (desc @ codebook.T).argmax(dim=-1)
    K = codebook.shape[0]
    sums = torch.zeros_like(codebook).index_add_(0, words, desc)
    cnt = torch.zeros(K, 1, dtype=torch.float32,
                      device=desc.device).index_add_(
        0, words, torch.ones(words.shape[0], 1, device=desc.device))
    new = torch.where(cnt > 0, sums / cnt.clamp_min(1.0), codebook)
    return new / torch.linalg.norm(new, dim=-1, keepdim=True).clamp_min(1e-8)


# ---------------------------------------------------------------------------
# Host-side inverted file
# ---------------------------------------------------------------------------

_POPCNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def _pack_bits(sign_rows: np.ndarray) -> np.ndarray:
    """±1 float (R, D) → packed uint8 (R, ceil(D/8))."""
    return np.packbits((sign_rows > 0).astype(np.uint8), axis=-1)


class RetrievalDatabase:
    """Incremental inverted file over binarized per-word aggregated
    residuals, with the reference's ``update(frame, add_after_query, k,
    min_thresh)`` API."""

    # the selective kernel's power, and the multiple-assignment counts: the
    # reference quantizes each query descriptor to its 5 nearest words and
    # builds the inverted file with 1
    alpha = 3.0
    ma_query = 5
    ma_build = 1

    def __init__(self, cfg, codebook_size=1024, nfeat=256, desc_dim=1024,
                 head_params=None):
        self.cfg = cfg
        self.K = codebook_size
        self.nfeat = nfeat
        self.desc_dim = desc_dim
        self.head_residual = False
        if head_params is not None:
            head_params = dict(head_params)
            self.head_residual = bool(head_params.pop("residual", False))
        self._head_host = head_params
        self.head_params = None          # on the features' device, at use
        # one-entry signature cache: relocalization queries and then
        # inserts the same frame back to back
        self._sig_cache = None

        self.codebook: torch.Tensor | None = None
        self._pending_codebook = None
        self._bootstrap_pool: list[np.ndarray] = []
        self._bootstrap_target = 4 * codebook_size
        self._pending: list[tuple[int, np.ndarray]] = []

        self.ivf_ids: list[list[int]] = [[] for _ in range(self.K)]
        self.ivf_sig: list[list[np.ndarray]] = [[] for _ in range(self.K)]
        self.kf_counter = 0
        # internal insertion id → keyframe-buffer index (they diverge under
        # --resume and out-of-order reloc inserts)
        self.id_to_kf: list[int] = []
        self.image_norms: list[float] = []
        self.device = None

    def _to_device(self, device):
        if self.device is not None:
            return
        self.device = torch.device(device)

        def move(v):
            if isinstance(v, dict):
                return {k: move(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [move(x) for x in v]
            return torch.as_tensor(v, dtype=torch.float32,
                                   device=self.device)

        if self._head_host is not None:
            self.head_params = move(self._head_host)
        if self._pending_codebook is not None:
            self.codebook = torch.as_tensor(self._pending_codebook,
                                            device=self.device)
            self._pending_codebook = None

    # -- codebook bootstrap -------------------------------------------------

    def _ensure_codebook(self, desc_np: np.ndarray):
        if self.codebook is not None:
            return
        self._bootstrap_pool.append(desc_np)
        total = sum(p.shape[0] for p in self._bootstrap_pool)
        if total >= self._bootstrap_target or len(self._bootstrap_pool) >= 8:
            pool = np.concatenate(self._bootstrap_pool, axis=0)
            rng = np.random.default_rng(0)
            sel = rng.choice(pool.shape[0], self.K,
                             replace=pool.shape[0] < self.K)
            cb = torch.as_tensor(pool[sel], device=self.device)
            cb = cb / torch.linalg.norm(cb, dim=-1,
                                        keepdim=True).clamp_min(1e-8)
            pool_t = torch.as_tensor(pool, device=self.device)
            for _ in range(4):
                cb = lloyd_step(pool_t, cb)
            self.codebook = cb
            self.desc_dim = int(cb.shape[1])
            self._bootstrap_pool = []

    def set_codebook(self, cb):
        cb = np.asarray(cb, dtype=np.float32)
        if cb.shape[0] != self.K:
            if self.kf_counter > 0:
                raise ValueError(
                    f"cannot swap codebook size {self.K} -> {cb.shape[0]} "
                    "after keyframes were indexed")
            self.K = int(cb.shape[0])
            self.ivf_ids = [[] for _ in range(self.K)]
            self.ivf_sig = [[] for _ in range(self.K)]
        if self.device is None:
            self._pending_codebook = cb
            self.codebook = torch.as_tensor(cb)     # shape and presence
        else:
            self.codebook = torch.as_tensor(cb, device=self.device)
        self.desc_dim = int(cb.shape[1])
        self._flush_pending()

    # -- signature construction ---------------------------------------------

    def _signature_from_desc(self, desc_np, ma=1):
        agg_sign, mask = aggregate_binarize(
            torch.as_tensor(desc_np, device=self.device), self.codebook,
            ma=ma)
        words = np.where(mask.cpu().numpy())[0]
        packed = _pack_bits(agg_sign.cpu().numpy()[words])
        return words, packed

    def _signature(self, feat):
        """Keyframe tokens ``(1, N, D)`` → ((build_words, build_packed,
        query_words, query_packed), desc (nfeat, D) on the host)."""
        self._to_device(feat.device)
        desc = select_local_features(feat[0], self.head_params, self.nfeat,
                                     self.head_residual)
        desc_np = desc.cpu().numpy()
        self._ensure_codebook(desc_np)
        if self.codebook is None:
            # still bootstrapping: the keyframe is indexed retroactively
            empty = (np.zeros((0,), np.int64), np.zeros((0, 1), np.uint8))
            return (*empty, *empty), desc_np
        sig_b = self._signature_from_desc(desc_np, self.ma_build)
        sig_q = (sig_b if self.ma_query == self.ma_build
                 else self._signature_from_desc(desc_np, self.ma_query))
        return (*sig_b, *sig_q), desc_np

    def _insert(self, words, packed, kf_idx):
        internal = self.kf_counter
        for w, sig in zip(words, packed):
            self.ivf_ids[int(w)].append(internal)
            self.ivf_sig[int(w)].append(sig)
        self.image_norms.append(float(len(words)))
        self.id_to_kf.append(internal if kf_idx is None else int(kf_idx))
        self.kf_counter += 1

    def _flush_pending(self):
        """Index the keyframes seen before the codebook existed: otherwise
        loop closures back to the start would be impossible."""
        if self.codebook is None or self.device is None or not self._pending:
            return
        for kf_idx, desc_np in self._pending:
            words, packed = self._signature_from_desc(desc_np, self.ma_build)
            self._insert(words, packed, kf_idx)
        self._pending = []

    # -- scoring --------------------------------------------------------------

    def _score(self, words: np.ndarray, packed: np.ndarray) -> np.ndarray:
        """Selective hamming-kernel ASMK score against every stored
        keyframe; hamming distances are normalised by the uint32-padded bit
        count, as the reference's."""
        scores = np.zeros(self.kf_counter, np.float64)
        nbits = 32 * ((self.desc_dim + 31) // 32)
        for w, sig in zip(words, packed):
            ids = self.ivf_ids[w]
            if not ids:
                continue
            stored = np.stack(self.ivf_sig[w])
            ham = _POPCNT[np.bitwise_xor(stored, sig[None])].sum(axis=1)
            sim = 1.0 - 2.0 * ham / nbits
            sim = np.where(sim > 0, sim, 0.0) ** self.alpha
            np.add.at(scores, np.asarray(ids), sim)
        norms = np.sqrt(np.maximum(np.asarray(self.image_norms), 1.0))
        q_norm = np.sqrt(max(len(words), 1))
        return scores / (norms * q_norm)

    # -- public API -----------------------------------------------------------

    def update(self, frame, add_after_query: bool, k: int,
               min_thresh: float = 0.0, kf_idx: int | None = None,
               skip_query: bool = False) -> list[int]:
        """Query the top-k loop-closure candidates (keyframe-buffer
        indices), then optionally insert ``frame`` at ``kf_idx``."""
        key = (getattr(frame, "frame_id", None), id(frame.feat))
        if self._sig_cache is not None and self._sig_cache[0] == key:
            sigs, desc_np = self._sig_cache[1]
        else:
            sigs, desc_np = self._signature(frame.feat)
            self._sig_cache = (key, (sigs, desc_np))
        words_b, packed_b, words_q, packed_q = sigs
        self._flush_pending()

        top: list[int] = []
        if not skip_query and self.kf_counter > 0 and len(words_q) > 0:
            scores = self._score(words_q, packed_q)
            order = np.argsort(-scores)[:k]
            top = [self.id_to_kf[int(i)] for i in order
                   if scores[i] > min_thresh]

        if add_after_query:
            if self.codebook is None:
                self._pending.append(
                    (self.kf_counter + len(self._pending)
                     if kf_idx is None else int(kf_idx), desc_np))
            else:
                self._insert(words_b, packed_b, kf_idx)
        return top
