"""A small JPEG encoder in numpy, for writing test clips where no OpenCV or
PIL is installed (``chip_smoke.py`` on the card machine, the Replica clips
of the CPU tests). Test scaffolding, not a package feature.

It writes JFIF files: 4:2:0 YCbCr (or gray), the quantization tables of
the JPEG standard's Annex K scaled by the IJG quality formula, the Annex K
Huffman tables, and either baseline scans (with an optional restart
interval and, for tests of the decoder, non-interleaved scans: one per
component) or progressive ones with the same quantized coefficients, in
the scan script of libjpeg's ``jpeg_simple_progression`` (spectral
selection and successive approximation; each end-of-band run is one
block long). The forward DCT is a float64 matrix product. Entropy coding
is vectorized: every Huffman symbol of the image is built as one (code,
length) pair, and the pairs are packed into bits at once.
"""

from __future__ import annotations

import numpy as np

# Annex K.1 quantization tables, natural (row-major) order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# zigzag index -> natural index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.3 Huffman tables: (code counts by length 1..16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _dct_matrix():
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return c * np.cos((2 * n + 1) * k * np.pi / 16)


_DCT = _dct_matrix()


def quality_table(base, quality):
    """IJG's ``jpeg_quality_scaling``: Annex K scaled, in [1, 255]."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _codes(table):
    """symbol -> (code, length) of a canonical Huffman table."""
    counts, symbols = table
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    for s, (c, n) in out.items():
        code[s], size[s] = c, n
    return code, size


def _bit_length(v):
    """Bits of |v| (the JPEG magnitude category), elementwise."""
    a = np.abs(v)
    return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))) + 1,
                    0).astype(np.int64)


def _blocks(plane, by, bx):
    """(by*8, bx*8) plane → (by*bx, 8, 8) blocks in raster order."""
    return plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _pad(plane, h, w):
    """Edge-replicate a plane to (h, w)."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])),
                  mode="edge")


def _dc_events(dc, dc_tab, dc_pred_reset):
    """The DC differences of a sequence of blocks as (value, length) bit
    groups; ``dc_pred_reset`` (B,) bool, True where the predictor restarts
    at 0."""
    prev = np.concatenate([[0], dc[:-1]])
    prev[dc_pred_reset] = 0
    diff = dc - prev
    dcode, dsize = dc_tab
    s = _bit_length(diff)
    extra = np.where(diff >= 0, diff, diff + (1 << s) - 1)
    return (dcode[s] << s) | extra, dsize[s] + s


def _band_events(band, ac_tab):
    """The AC symbols of ``band`` (B, n) coefficient values in zigzag order
    (a spectral band of each block): runs, ZRLs and an end of band (a run
    of one block) where the band ends in zeros. Returns (values, lengths,
    block, key), ``key`` the order within the block."""
    B, n = band.shape
    acode, asize = ac_tab
    b, k = np.nonzero(band)
    first = np.ones(b.size, bool)
    first[1:] = b[1:] != b[:-1]
    prevk = np.where(first, -1, np.concatenate([[0], k[:-1]]))
    run = k - prevk - 1
    v = band[b, k]
    s = _bit_length(v)
    extra = np.where(v >= 0, v, v + (1 << s) - 1)
    sym = ((run % 16) << 4) | s
    ev = [(b, k.astype(np.float64), (acode[sym] << s) | extra,
           asize[sym] + s)]
    # runs of 16 zeros (ZRL, symbol 0xF0) before a coefficient
    nz = run // 16
    zb = np.repeat(b, nz)
    ev.append((zb, np.repeat(k - 0.5, nz), np.full(zb.size, acode[0xF0]),
               np.full(zb.size, asize[0xF0])))
    # end of band where the last coefficient is zero
    last = np.full(B, -1, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < n - 1)[0]
    ev.append((eob, np.full(eob.size, float(n)), np.full(eob.size,
                                                         acode[0x00]),
               np.full(eob.size, asize[0x00])))
    blk, key, vals, lens = (np.concatenate(x) for x in zip(*ev))
    return vals, lens, blk, key


def _refine_events(band, al, ac_tab):
    """An AC successive-approximation refinement scan of ``band`` (B, n)
    final coefficient values (jcphuff.c encode_mcu_AC_refine, each end of
    band a run of one block): bit ``al`` of every coefficient, as a newly
    nonzero coefficient's symbol and sign or as a correction bit of one
    that was nonzero before, which rides after the next symbol. Returns
    (values, lengths, block, key)."""
    B, n = band.shape
    acode, asize = ac_tab
    a = np.abs(band) >> al
    new, old, zero = a == 1, a > 1, a == 0
    pos = np.broadcast_to(np.arange(n), (B, n))
    eob = np.where(new, pos, -1).max(axis=1)          # last new coefficient
    # zeros since the last new coefficient, before each position
    zb = np.concatenate([np.zeros((B, 1), np.int64),
                         np.cumsum(zero, axis=1)], axis=1)
    last_new = np.maximum.accumulate(
        np.concatenate([np.full((B, 1), -1), np.where(new, pos, -1)[:, :-1]],
                       axis=1), axis=1)
    z = zb[:, :n] - np.take_along_axis(zb, last_new + 1, axis=1)
    live = (new | old) & (pos <= eob[:, None])
    c = np.where(live, z // 16, 0)                     # ZRLs so far
    seg = np.concatenate([np.zeros((B, 1), np.int64),
                          np.cumsum(new, axis=1)[:, :-1]], axis=1)
    big = n + 1
    acc = np.maximum.accumulate(seg * big + c, axis=1) - seg * big
    prev_c = np.concatenate([np.zeros((B, 1), np.int64), acc[:, :-1]],
                            axis=1)
    prev_c = np.where(np.concatenate([np.zeros((B, 1), bool),
                                      new[:, :-1]], axis=1), 0, prev_c)
    zrl = np.where(live, c - prev_c, 0)
    flush = (zrl > 0) | new
    # each old coefficient's bit rides after the first flush past it
    fpos = np.where(flush, pos, n)
    nxt = np.minimum.accumulate(fpos[:, ::-1], axis=1)[:, ::-1]
    after = np.concatenate([nxt[:, 1:], np.full((B, 1), n)], axis=1)
    ev = []
    bz, kz = np.nonzero(zrl)
    cnt = zrl[bz, kz]
    rb, rk = np.repeat(bz, cnt), np.repeat(kz, cnt)
    idx = np.arange(rb.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ev.append((rb, rk, np.where(idx == 0, 0, 2), idx,
               np.full(rb.size, acode[0xF0]), np.full(rb.size, asize[0xF0])))
    bn, kn = np.nonzero(new)
    sym = ((z[bn, kn] % 16) << 4) | 1
    sign = (band[bn, kn] > 0).astype(np.int64)
    ev.append((bn, kn, np.full(bn.size, 3), np.zeros(bn.size, np.int64),
               (acode[sym] << 1) | sign, asize[sym] + 1))
    be = np.nonzero(eob < n - 1)[0]
    ev.append((be, np.full(be.size, n), np.zeros(be.size, np.int64),
               np.zeros(be.size, np.int64), np.full(be.size, acode[0x00]),
               np.full(be.size, asize[0x00])))
    bo, ko = np.nonzero(old)
    f = after[bo, ko]
    at_zrl = np.where(f < n, zrl[bo, np.minimum(f, n - 1)] > 0, True)
    ev.append((bo, f, np.where(at_zrl, 1, 4), ko, a[bo, ko] & 1,
               np.ones(bo.size, np.int64)))
    blk, k, sub, j, vals, lens = (np.concatenate(x) for x in zip(*ev))
    key = (k * 8 + sub) * (n + 1) + j
    return vals, lens, blk, key.astype(np.float64)


def _symbols(zz, dc_tab, ac_tab, dc_pred_reset):
    """The (value, length) bit groups of a sequence of blocks.

    ``zz`` (B, 64) quantized coefficients in zigzag order; ``dc_pred_reset``
    (B,) bool, True where the DC predictor restarts at 0."""
    B = zz.shape[0]
    dv, dl = _dc_events(zz[:, 0], dc_tab, dc_pred_reset)
    av, al, ab, ak = _band_events(zz[:, 1:], ac_tab)
    blk = np.concatenate([np.arange(B), ab])
    key = np.concatenate([np.full(B, -1.0), ak])
    order = np.lexsort((key, blk))
    return (np.concatenate([dv, av])[order].astype(np.int64),
            np.concatenate([dl, al])[order].astype(np.int64), blk[order])


def _pack(vals, lens):
    """Bit groups → bytes, padded with 1 bits, 0xFF stuffed with 0x00."""
    total = int(lens.sum())
    if total == 0:
        return b""
    ends = np.cumsum(lens)
    idx = np.repeat(np.arange(vals.size), lens)
    pos = np.arange(total) - np.repeat(ends - lens, lens)
    bits = (vals[idx] >> (lens[idx] - 1 - pos)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _dht(tc, th, table):
    counts, symbols = table
    return bytes([(tc << 4) | th]) + bytes(counts) + bytes(symbols)


# jcparam.c jpeg_simple_progression: (components, Ss, Se, Ah, Al) of each
# scan, for YCbCr and for a single component
_SCRIPT_YCC = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
               ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
               ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
               ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
               ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))
_SCRIPT_GRAY = (((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0))


def encode_jpeg(img, quality=90, restart_interval=0, interleaved=True,
                progressive=False):
    """uint8 ``(H, W, 3)`` RGB (4:2:0) or ``(H, W)`` gray → JPEG bytes.
    ``progressive`` writes the same quantized coefficients in
    ``jpeg_simple_progression``'s scans (no restart interval)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected uint8 (H, W[, 3]), got {img.dtype} "
                         f"{img.shape}")
    if progressive and restart_interval:
        raise ValueError("progressive files are written without restarts")
    H, W = img.shape[:2]
    gray = img.ndim == 2
    qt = [quality_table(_Q_LUMA, quality), quality_table(_Q_CHROMA, quality)]
    if gray:
        planes, samp, tabs = [img.astype(np.float64)], [(1, 1)], [0]
    else:
        rgb = img.astype(np.float64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
        planes, samp, tabs = [y, cb, cr], [(2, 2), (1, 1), (1, 1)], [0, 1, 1]
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    comps = []
    for plane, (h, v), t in zip(planes, samp, tabs):
        ph, pw = my * v * 8, mx * h * 8
        if (h, v) != (hmax, vmax):   # 2x2 box average of the padded plane
            full = _pad(plane, my * vmax * 8, mx * hmax * 8)
            plane = full.reshape(ph, 2, pw, 2).mean(axis=(1, 3))
        else:
            plane = _pad(plane, ph, pw)
        blocks = _blocks(plane - 128.0, my * v, mx * h)
        coef = _DCT @ blocks @ _DCT.T
        quant = np.round(coef.reshape(-1, 64) / qt[t]).astype(np.int64)
        comps.append(dict(h=h, v=v, t=t, bx=mx * h, by=my * v,
                          zz=quant[:, ZIGZAG],
                          dw=-(-W * h // hmax), dh=-(-H * v // vmax)))

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                 b"\x01\x00\x00")]
    for t in range(1 if gray else 2):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            qt[t][ZIGZAG].astype(np.uint8))))
    sof = bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") + bytes(
        [len(comps)])
    for i, c in enumerate(comps):
        sof += bytes([i + 1, (c["h"] << 4) | c["v"], c["t"]])
    out.append(_segment(0xC2 if progressive else 0xC0, sof))
    tables = [(_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA)]
    dht = b""
    for t in range(1 if gray else 2):
        dht += _dht(0, t, tables[t][0]) + _dht(1, t, tables[t][1])
    out.append(_segment(0xC4, dht))
    if restart_interval:
        out.append(_segment(0xDD, restart_interval.to_bytes(2, "big")))

    def events(i, zz, first, ss, se, ah, al):
        """One component's bit groups in a scan: (values, lengths, index
        of the block in the component's coding order)."""
        dc_tab, ac_tab = (_codes(x) for x in tables[comps[i]["t"]])
        if not progressive:
            return _symbols(zz, dc_tab, ac_tab, first)
        if ss == 0 and ah == 0:
            v, n = _dc_events(zz[:, 0] >> al, dc_tab, first)
            return v, n, np.arange(zz.shape[0])
        if ss == 0:
            return ((zz[:, 0] >> al) & 1, np.ones(zz.shape[0], np.int64),
                    np.arange(zz.shape[0]))
        band = zz[:, ss:se + 1]
        if ah == 0:
            v, n, b, k = _band_events(np.sign(band) * (np.abs(band) >> al),
                                      ac_tab)
        else:
            v, n, b, k = _refine_events(band, al, ac_tab)
        o = np.lexsort((k, b))
        return v[o].astype(np.int64), n[o].astype(np.int64), b[o]

    def scan(ids, order, mcu_of, ss=0, se=63, ah=0, al=0):
        """One scan: components ``ids``; ``order`` (comp, block) pairs in
        coding order; ``mcu_of`` the MCU index of each."""
        header = bytes([len(ids)])
        for i in ids:
            header += bytes([i + 1, (comps[i]["t"] << 4) | comps[i]["t"]])
        out.append(_segment(0xDA, header + bytes([ss, se, (ah << 4) | al])))
        n_mcu = int(mcu_of.max()) + 1
        interval = restart_interval or n_mcu
        vals, lens, inter = [], [], []
        for i in ids:
            sel = order[:, 0] == i
            blk, mcu = order[sel, 1], mcu_of[sel]
            zz = comps[i]["zz"][blk]
            first = np.ones(blk.size, bool)
            first[1:] = (mcu[1:] // interval) != (mcu[:-1] // interval)
            v, n, b = events(i, zz, first, ss, se, ah, al)
            # position of each bit group in coding order
            rank = np.nonzero(sel)[0][b]
            vals.append(v)
            lens.append(n)
            inter.append(rank)
        v, n = np.concatenate(vals), np.concatenate(lens)
        rank = np.concatenate(inter)
        o = np.argsort(rank, kind="stable")
        v, n, rank = v[o], n[o], rank[o]
        seg = mcu_of[rank] // interval
        for r in range(int(seg.max()) + 1 if seg.size else 1):
            if r:
                out.append(bytes([0xFF, 0xD0 + (r - 1) % 8]))
            m = seg == r
            out.append(_pack(v[m], n[m]))

    def interleaved_order(ids):
        order, mcu_of = [], []
        for m in range(mx * my):
            r, c0 = divmod(m, mx)
            for i in ids:
                c = comps[i]
                for y in range(c["v"]):
                    for x in range(c["h"]):
                        order.append((i, (r * c["v"] + y) * c["bx"]
                                      + c0 * c["h"] + x))
                        mcu_of.append(m)
        return np.array(order), np.array(mcu_of)

    def single_order(i):
        c = comps[i]
        nbx, nby = -(-c["dw"] // 8), -(-c["dh"] // 8)
        order = np.array([(i, y * c["bx"] + x) for y in range(nby)
                          for x in range(nbx)])
        return order, np.arange(len(order))

    if progressive:
        for ids, ss, se, ah, al in (_SCRIPT_GRAY if gray else _SCRIPT_YCC):
            order, mcu_of = (interleaved_order(ids) if len(ids) > 1
                             else single_order(ids[0]))
            scan(list(ids), order, mcu_of, ss, se, ah, al)
    elif interleaved and len(comps) > 1:
        scan(list(range(len(comps))), *interleaved_order(range(len(comps))))
    else:   # one scan a component (a gray image's only scan is such)
        for i in range(len(comps)):
            scan([i], *single_order(i))
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path, img, quality=90, **kw) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality, **kw))
