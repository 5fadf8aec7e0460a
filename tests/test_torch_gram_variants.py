"""Port parity of K4′, the BA Gram microbenchmark's four bodies
(mast3r_slam_tpu_torch/ops/gram_variants.py): each plain version against
the JAX script's Pallas body (``scripts/gram_kernel_bench.py``) run through
its ``run_variant`` in interpret mode, on the script's random channels and
on premeas channels, float32 and bfloat16.

Tolerances: the scalar sums within 1e-5 of Σ|terms| (float64; the TPU body
sums in float32 per tile); the Grams entry by entry against their rows'
scale (``ba_kernels.gram_error``), 1e-5 with float32 rows and 1e-4 with
bfloat16 rows (a weight one float32 ulp apart can round its row to the
neighbouring bfloat16 value), as K4's test. One exception: float32 rows on
the script's random channels are held to 1e-4. There a ray channel's
``m·X'`` row, ``dinv (px - rx d)``, is zero up to rounding, and on the
random points XLA's rounding of that cancellation and torch's part by up to
1.2x the row's own size; the Gram of those rows then reads 2.3e-5 (diag)
and 4.4e-5 (one product) against the float64 Gram of the port's rows, while
a float32 product of the port's rows reads 8e-8 / 3e-7. On premeas
channels the same rows meet 1e-5."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import ba_kernels as JK
from mast3r_slam_tpu.ops import lie as JL
from mast3r_slam_tpu.slam import factor_graph as JFG
from mast3r_slam_tpu_torch.bench import gram_kernel_bench as TB
from mast3r_slam_tpu_torch.ops import ba_kernels as TK
from mast3r_slam_tpu_torch.ops import gram_variants as GV
from torch_parity import torch_one_thread  # noqa: F401
from torch_parity import ba_edges

ROOT = Path(__file__).resolve().parents[1]
E, N = 2, 2048
SCRIPT_SIGMAS = (TB.SIGMA_RAY, TB.SIGMA_DIST)
PREMEAS_SIGMAS = (0.003, 10.0)
GRAM_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
# float32 rows on the script's random channels (see the module docstring)
SCRIPT_F32_TOL = 1e-4


@pytest.fixture(scope="module")
def script():
    """``scripts/gram_kernel_bench.py`` loaded by path (``scripts/`` is not
    a package)."""
    spec = importlib.util.spec_from_file_location(
        "gram_kernel_bench_script", ROOT / "scripts" / "gram_kernel_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(script, monkeypatch):
    """The script's ``pallas_call`` in interpret mode, 128-lane tiles."""
    monkeypatch.setattr(script.pl, "pallas_call",
                        functools.partial(script.pl.pallas_call,
                                          interpret=True))
    monkeypatch.setattr(script.BK, "_TNL", 128)
    return script


def _script_channels(meas_dtype):
    """The bench's inputs (the script's draws) as numpy, channels in
    ``meas_dtype``."""
    rts, meas = TB.make_inputs(E, N)
    return (rts.numpy(), [ch.float().numpy() for ch in meas], meas_dtype,
            SCRIPT_SIGMAS)


def _premeas_channels(meas_dtype):
    """Measured ray channels of ``torch_parity.ba_edges`` (JAX premeas)."""
    T, X, Cavg, ii, jj, idx, valid, Q, mask = (jnp.asarray(a) for a in
                                                ba_edges(5, E=3, N=N))
    meas = JFG._premeas_rays(X, Cavg, ii, jj, idx, valid, Q, 0.5, 0.5)
    _, rts = JFG._rel_pose_rows(T, ii, jj, mask)
    return (np.array(rts), [np.array(ch, np.float32) for ch in meas],
            meas_dtype, PREMEAS_SIGMAS)


SOURCES = {"script": _script_channels, "premeas": _premeas_channels}


def _both(inputs):
    """The same numbers for both packages: JAX channels in the script's
    sublane-split layout, torch channels flat."""
    rts, meas, dtype, sig = inputs
    jm = JK.view_sublane_split(tuple(jnp.asarray(ch).astype(dtype)
                                     for ch in meas))
    tm = [torch.from_numpy(ch).to(TK.as_dtype(dtype)) for ch in meas]
    return jnp.asarray(rts), jm, torch.from_numpy(rts), tm, sig


@pytest.mark.parametrize("meas_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", list(SOURCES))
# rows_fast (K4's tensor-core row arithmetic) has the rows body's function
@pytest.mark.parametrize("name", ["load", "rows", "rows_fast"])
def test_sum_plain_version_matches_pallas_body(interpret, name, source,
                                               meas_dtype):
    jrts, jm, trts, tm, sig = _both(SOURCES[source](meas_dtype))
    if name == "load":
        body, args = interpret._load_kernel, (trts, tm)
        got = GV.gram_load(*args)
    else:
        body = functools.partial(interpret._rows_kernel, sigma_ray=sig[0],
                                 sigma_dist=sig[1])
        args = (trts, tm, *sig)
        got = getattr(GV, f"gram_{name}")(*args)
    want = np.asarray(interpret.run_variant(body, jrts, jm, 1,
                                            scalar_out=True))
    assert got.shape == want.shape == (trts.shape[0], 1, 1)
    scale = GV.abs_sum(*args).numpy()
    assert np.all(scale > 0)
    err = np.abs(got.double().numpy() - want.astype(np.float64))
    assert np.all(err <= 1e-5 * scale), (err / scale).max()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("meas_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("name", ["diag", "one_product"])
def test_gram_plain_version_matches_pallas_body(interpret, name, source,
                                                meas_dtype, compute):
    jrts, jm, trts, tm, sig = _both(SOURCES[source](meas_dtype))
    kw = dict(sigma_ray=sig[0], sigma_dist=sig[1],
              compute_dtype=jnp.dtype(compute))
    if name == "diag":
        body, rows = functools.partial(interpret._diag_kernel, **kw), 8
        got = GV.gram_diag(trts, tm, *sig, compute_dtype=compute)
    else:
        body, rows = functools.partial(interpret._gram32_kernel_2c, **kw), 32
        got = GV.gram_one_product(trts, tm, *sig, compute_dtype=compute)
    want = torch.from_numpy(np.array(interpret.run_variant(body, jrts, jm,
                                                           rows)))
    assert got.shape == want.shape == (trts.shape[0], rows, rows)
    assert want.abs().max() > 0
    err = TK.gram_error(got, want)
    tol = (SCRIPT_F32_TOL if (source, compute) == ("script", "float32")
           else GRAM_TOL[compute])
    assert err <= tol, err


@pytest.mark.parametrize("meas_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("name", ["diag", "one_product"])
def test_kernel_order_gram_matches_pallas_body(interpret, name, source,
                                               meas_dtype):
    """What K4′c and K4′d compute with bfloat16 rows on the card: the rows
    on K4's tensor-core arithmetic (``ba_kernels.rays_rows_kernel_order``:
    rsqrt norm, reciprocal sigmas, ``sqrt(k) rsqrt(w)`` Huber), rounded to
    bfloat16, their diagonal-block and full Grams against the JAX bodies
    (IEEE rows) at the bfloat16 rows' tolerance."""
    jrts, jm, trts, tm, sig = _both(SOURCES[source](meas_dtype))
    kw = dict(sigma_ray=sig[0], sigma_dist=sig[1],
              compute_dtype=jnp.dtype("bfloat16"))
    rows = TK.rays_rows_kernel_order(trts, tm, *sig)
    if name == "diag":
        body, n = functools.partial(interpret._diag_kernel, **kw), 8
        got = GV.diag_of_rows(rows, torch.bfloat16)
    else:
        body, n = functools.partial(interpret._gram32_kernel_2c, **kw), 32
        got = TK._gram(rows, torch.bfloat16)
    want = torch.from_numpy(np.array(interpret.run_variant(body, jrts, jm,
                                                           n)))
    assert got.shape == want.shape == (trts.shape[0], n, n)
    assert want.abs().max() > 0
    err = TK.gram_error(got, want)
    assert err <= GRAM_TOL["bfloat16"], err


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", list(SOURCES))
def test_script_identities(source, compute):
    """The script's own identities: v3 is the sum of v0's diagonal blocks,
    v2c is v0."""
    *_, trts, tm, sig = _both(SOURCES[source]("bfloat16"))
    G = TK.gram_rays_ref(trts, tm, *sig, compute_dtype=compute)
    diag = GV.gram_diag_ref(trts, tm, *sig, compute_dtype=compute)
    assert TK.gram_error(diag, TB.diag_blocks(G)) <= 1e-6
    assert torch.equal(GV.gram_one_product_ref(trts, tm, *sig,
                                               compute_dtype=compute), G)


def test_bench_inputs_match_the_script():
    """``make_inputs`` draws what the JAX script's ``main`` draws from seed
    0: the same bf16 channels and ``rts`` within 1e-6."""
    e, n = 6, 256
    rng = np.random.default_rng(0)
    meas = [jnp.abs(jnp.asarray(rng.normal(size=(e, n)).astype(np.float32)
                                * 0.3 + 1.0)).astype(jnp.bfloat16)
            for _ in range(8)]
    T = jax.vmap(JL.exp)(jnp.asarray(
        rng.normal(size=(110, 7)).astype(np.float32) * 0.02))
    ii = jnp.asarray(rng.integers(0, 110, e).astype(np.int32))
    jj = jnp.asarray((np.asarray(ii) + 1) % 110)
    _, rts = JFG._rel_pose_rows(T, ii, jj, jnp.ones(e, jnp.float32))
    t_rts, t_meas = TB.make_inputs(e, n)
    np.testing.assert_allclose(t_rts.numpy(), np.asarray(rts), rtol=0,
                               atol=1e-6)
    for a, b in zip(t_meas, meas):
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))


@pytest.mark.parametrize("r2", [False, True])
def test_bench_main_runs_on_the_cpu_when_asked(r2, capsys):
    """``main`` with ``device="cpu"``: the plain versions, every time
    labelled cpu, and the script's agreement lines."""
    argv = ["--edges", "2", "--pixels", "1024"]
    out = TB.main(argv + (["--r2"] if r2 else []), device="cpu")
    text = capsys.readouterr().out
    assert out["device"] == "cpu" and "ms (cpu)" in text
    key = "v2c_vs_v0" if r2 else "v3_vs_v0"
    assert out[key]["gram_error"] <= 1e-6
    assert set(out["ms"]) == ({"v2c", "v0"} if r2 else
                              {"v1", "v2", "v2f", "v3", "v0f", "v0"})


def test_bench_grids_need_the_card():
    """``--grids`` times the card's grids: on the CPU it raises."""
    with pytest.raises(RuntimeError, match="card"):
        TB.main(["--grids", "--edges", "2", "--pixels", "256"], device="cpu")


@pytest.mark.parametrize("prod,N", [((2, 192), 98_304), ((1, 4), 1_000),
                                    ((64, 6), 98_304), ((1, 1), 7)])
def test_sweep_grids_cover_the_tiles(prod, N):
    """Every grid of a sweep covers the 256-pixel tiles without a block
    that has none, holds the production grid and no duplicate."""
    grids = TB.sweep_grids(prod, N)
    n_tiles = -(-N // TK.THREADS)
    assert prod in grids and len(set(grids)) == len(grids)
    for bpe, tiles in grids:
        assert bpe * tiles >= n_tiles > (bpe - 1) * tiles


def test_sass_count_finds_the_loop_body():
    """``bench/sass_count.py`` on a made-up listing: the loop is the
    labelled target through its backward branch, a branch to itself is no
    loop, and the body's ops are sorted into classes."""
    from mast3r_slam_tpu_torch.bench import sass_count as SC

    sass = """
        Function : _ZN12_GLOBAL__N_114gram_tc_kernelILb0ELb1EEEv6Params
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_3:
        /*0010*/                   MUFU.RSQ R5, R4 ;
        /*0020*/                   FFMA R6, R5, R5, R4 ;
        /*0030*/              @!P0 CALL.REL.NOINC `($_slowpath) ;
        /*0040*/                   HMMA.16816.F32.BF16 R8, R12, R14, R8 ;
        /*0050*/                   NOP ;
        /*0060*/               @P1 BRA `(.L_x_3) ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80 ;
"""
    (name, insns), = SC.parse(sass).items()
    assert "gram_tc_kernel" in name and len(insns) == 9
    assert SC.loops(insns) == [(1, 6)]
    ops = [SC.opcode(t) for _, t, _ in insns[1:7] if SC.opcode(t) != "NOP"]
    assert SC.classify(ops) == {"MUFU": 1, "fp32": 1, "mma": 1,
                                "branch/sync": 2}


@pytest.mark.parametrize("meas_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", list(SOURCES))
def test_one_live_pixel_sum_matches_pallas_body(interpret, source,
                                                meas_dtype):
    """The construction K4′b's bitwise GPU tests take
    (``gram_variants.one_live_pixel``: one pixel of nonzero confidence an
    edge): its plain float32 row sums against the JAX body's within 1e-6
    of the live pixel's Σ|rows| (float64), each edge's sum that one pixel's
    32 rows. Relative to the sum itself the premeas rows read 6e-6: their
    float32 rounding differs between XLA and torch (module docstring)."""
    rts, meas, dtype, sig = SOURCES[source](meas_dtype)
    one, live = GV.one_live_pixel([torch.from_numpy(m) for m in meas], 3)
    jrts, jm, trts, tm, sig = _both((rts, [m.numpy() for m in one], dtype,
                                     sig))
    assert [int((m[4] != 0).sum()) for m in [tm]] == [trts.shape[0]]
    got = GV.gram_rows(trts, tm, *sig).double().numpy()
    body = functools.partial(interpret._rows_kernel, sigma_ray=sig[0],
                             sigma_dist=sig[1])
    want = np.asarray(interpret.run_variant(body, jrts, jm, 1,
                                            scalar_out=True), np.float64)
    scale = GV.abs_sum(trts, tm, *sig).numpy()
    assert np.all(want != 0)
    assert np.all(np.abs(got - want) <= 1e-6 * scale), (
        np.abs(got - want) / scale).max()


@pytest.mark.parametrize("sigmas", ["bench", "seeded"])
def test_host_reciprocal_is_the_float32_quotient(sigmas):
    """The reciprocal sigmas the rows kernels are passed are ``RN(1 /
    sigma)`` in float32 from the float32 sigma, which the kernel's x /
    sigma sequence needs (and its C entry checks), for the benchmark's
    sigmas and 1,000 seeded ones; a float64 quotient rounded to float32
    misses it for some of them."""
    if sigmas == "bench":
        sig = [TB.SIGMA_RAY, TB.SIGMA_DIST, *PREMEAS_SIGMAS]
    else:
        sig = list(10 ** np.random.default_rng(0).uniform(-5, 3, 1000))
    got = np.array([GV.host_reciprocal(s) for s in sig])
    want = np.float32(1) / np.array(sig, np.float32)
    assert np.array_equal(got, want.astype(np.float64))
    if sigmas == "seeded":
        via_f64 = (1.0 / np.array(sig)).astype(np.float32)
        assert np.any(via_f64 != want)


@pytest.mark.parametrize("vp", [1, 4])
@pytest.mark.parametrize("bps", [1, 2, 3])
@pytest.mark.parametrize("E,N", [(1, 98_304), (16, 98_304), (128, 98_304),
                                 (5, 1_000), (300, 7), (2, 1_001)])
def test_rows_grid_covers_the_tiles(E, N, bps, vp):
    """K4′b's one-wave planner (``gram_variants.grid_rows``) covers its
    tiles (``vp`` pixels a thread when N is a multiple, else one) without a
    block that has none, and fills at most one wave of ``bps`` blocks on
    each of 132 SMs where the edges leave room."""
    bpe, tiles = GV.grid_rows(E, N, 132, bps, vp)
    n_tiles = -(-N // GV.tile_pixels("rows", N, vp))
    assert bpe * tiles >= n_tiles > (bpe - 1) * tiles
    assert bpe * E <= max(bps * 132, E)


def test_sass_count_tells_slow_paths_from_the_fallback():
    """A call to a leaf subroutine (an IEEE slow path) counts as a
    slow-path call site; a call to a subroutine that calls others (K4′b's
    out-of-line fallback) counts as a call only."""
    from mast3r_slam_tpu_torch.bench import sass_count as SC

    sass = """
        Function : _ZN12_GLOBAL__N_111rows_kernelILb1ELi4ELb0EEEv6Params
        /*0000*/                   MOV R1, R2 ;
.L_x_1:
        /*0010*/              @!P0 CALL.REL.NOINC 0x60 ;
        /*0020*/              @!P1 CALL.REL.NOINC 0x90 ;
        /*0030*/               @P2 BRA `(.L_x_1) ;
        /*0040*/                   EXIT ;
        /*0050*/                   BRA 0x50 ;
        /*0060*/                   CALL.REL.NOINC 0x90 ;
        /*0070*/                   FADD R4, R4, R5 ;
        /*0080*/                   RET.REL.NODEC R6 0x0 ;
        /*0090*/                   MUFU.RSQ R4, R4 ;
        /*00a0*/                   RET.REL.NODEC R8 0x0 ;
"""
    (insns,) = SC.parse(sass).values()
    ((s, e),) = [lp for lp in SC.loops(insns) if lp[0] < lp[1]]
    assert SC.calls([t for _, t, _ in insns[s:e + 1]], insns) == (2, 1)
