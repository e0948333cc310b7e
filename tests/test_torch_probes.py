"""The port's measurement kernels T1-T3 against the JAX tools' Pallas bodies.

The JAX tools ``tools/bench_kernel_phases.py`` (T1 phase probes, T2
schedule variants) and ``tools/bench_kernel_ab.py`` (T3 DCE-proof QK
probes) are loaded by path (``tools/`` is not a package); their kernel
bodies run here in this file's own ``pl.pallas_call(..., interpret=True)``
at a small size: 2 steps of 256 rows, 2 heads x dh 64 (PV: 256 keys); T2 at
B = 2, S = 200 padded to 256, H = 4. Each is held against the port's plain
version (``kernels/qk_probes.py``, ``kernels/attention_variants.py``) on
the same numpy inputs. The CUDA kernels themselves are held against these
plain versions on the card by test_torch_cuda.py and chip_smoke.py.

Tolerances: bf16 outputs within one bf16 step of max |o| (both sides
accumulate in fp32 and round once; the order of the fp32 sums can flip
that rounding), two steps for qk+sm (it also rounds each exponential);
fp32 within 1e-5 relative to max |o|, where the body allows fp32
(``_sm_probe_kernel`` hard-codes bf16 exponentials). T2's schedules: bf16
4e-3 (outputs of order 0.1 to 1, rounded probabilities against a row max
that includes the padded keys' zero scores on the TPU side and not on the
port's), fp32 1e-5.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from video_depth_anything_torch import kernels
from video_depth_anything_torch.kernels import attention_variants as t2
from video_depth_anything_torch.kernels import qk_probes as qp
from video_depth_anything_torch.kernels.spatial_attention import spatial_attention_plain
from video_depth_anything_torch.tools import bench_kernel_ab, bench_kernel_phases, timing

ROOT = Path(__file__).resolve().parents[1]
STEPS, ROWS, W = 2, 256, 128


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PHASES = _load("bench_kernel_phases")
AB = _load("bench_kernel_ab")
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _uniform(shape, seed):
    return (np.random.default_rng(seed).random(shape, dtype=np.float32) - 0.5)


def _per_step(body, arrays, out_dtype):
    """The JAX tools' per-step pallas_call: one grid step per leading index,
    an output of the first operand's rows."""
    rows = arrays[0].shape[1]
    specs = [pl.BlockSpec((1, *a.shape[1:]), lambda i: (i, 0, 0)) for a in arrays]
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((STEPS, rows, W), out_dtype), grid=(STEPS,),
        in_specs=specs, out_specs=pl.BlockSpec((1, rows, W), lambda i: (i, 0, 0)),
        interpret=True)(*arrays), np.float32)


def _step(x):
    """One bf16 step (2^-7 relative) at x's binade."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _assert_held(got, want, dtype, bf16_steps=1):
    top = np.abs(want).max()
    tol = bf16_steps * _step(top) if dtype == "bfloat16" else 1e-5 * top
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol, top)


T1_CASES = [("qk64x2", "bfloat16"), ("qk64x2", "float32"), ("qk128", "bfloat16"),
            ("qk128", "float32"), ("qk+sm x2", "bfloat16"), ("pv128x2", "bfloat16"),
            ("pv128x2", "float32")]


@pytest.mark.parametrize("name,dtype", T1_CASES)
def test_t1_plain_matches_jax_body(name, dtype):
    jdt, tdt = DTYPES[dtype]
    if name == "pv128x2":
        x = [_uniform((STEPS, ROWS, ROWS), 0), _uniform((STEPS, ROWS, ROWS), 1),
             _uniform((STEPS, ROWS, W), 2)]
        body = functools.partial(PHASES._pv_probe_kernel, dh=64)
    else:
        x = [_uniform((STEPS, ROWS, W), 0), _uniform((STEPS, ROWS, W), 1)]
        body = {"qk64x2": functools.partial(PHASES._qk_probe_kernel, dh=64),
                "qk128": PHASES._qk128_probe_kernel,
                "qk+sm x2": functools.partial(PHASES._sm_probe_kernel, dh=64)}[name]
    want = _per_step(body, [jnp.asarray(a, jdt) for a in x], jdt)
    kernels.reset_launch_counts()
    got = qp.phase_probe(name, *(torch.from_numpy(a).to(tdt) for a in x))
    assert kernels.launch_counts()["phase_probes"] == 0   # CPU: plain version
    assert got.dtype == tdt and got.shape == (STEPS, ROWS, W)
    _assert_held(got.float().numpy(), want, dtype, 2 if name == "qk+sm x2" else 1)


# (heads, dtype, M, N): the tools' square case at 256, then the edges of
# the kernel's persistent walk: M = 192 (a full and a half 128-row tile)
# against one key tile, and a single half tile against five key tiles.
T3_CASES = [pytest.param(h, d, ROWS, ROWS, id=f"{h}-{d}")
            for h, d in ((2, "bfloat16"), (2, "float32"), (1, "bfloat16"), (1, "float32"))]
T3_CASES += [pytest.param(h, d, m, n, id=f"{h}-{d}-M{m}-N{n}")
             for m, n in ((192, 128), (64, 640)) for h in (2, 1) for d in ("bfloat16", "float32")]


@pytest.mark.parametrize("heads,dtype,m,n", T3_CASES)
def test_t3_plain_matches_jax_body(heads, dtype, m, n):
    """T3's output is fp32 whatever the inputs: every score column, summed
    in groups of 128 columns (and over the heads for qk64)."""
    jdt, tdt = DTYPES[dtype]
    x = [_uniform((STEPS, m, W), 3), _uniform((STEPS, n, W), 4)]
    body = functools.partial(AB._qk64_probe if heads == 2 else AB._qk128_probe, dh=64)
    want = _per_step(body, [jnp.asarray(a, jdt) for a in x], jnp.float32)
    got = qp.qk_probe(*(torch.from_numpy(a).to(tdt) for a in x), heads=heads)
    assert got.dtype == torch.float32 and got.shape == (STEPS, m, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("probe", ["t1", "t3"])
def test_two_64_deep_heads_sum_to_one_128_deep_product(probe):
    """Two 64-deep contractions summed are one 128-deep contraction: qk64x2
    equals qk128 (T1) and qk64 equals qk128 (T3) within fp32 rounding."""
    q, k = (torch.from_numpy(_uniform((STEPS, ROWS, W), s)) for s in (5, 6))
    if probe == "t1":
        two, one = (qp.phase_probe(n, q, k) for n in ("qk64x2", "qk128"))
    else:
        two, one = (qp.qk_probe(q, k, heads=h) for h in (2, 1))
    torch.testing.assert_close(two, one, rtol=1e-5, atol=1e-5 * one.abs().max().item())


def test_t1_softmax_side_sum_counts_every_exponential():
    """The side sum is sum_h sum_keys exp(s_h - max s_h) over every key."""
    q, k = (_uniform((STEPS, ROWS, W), s) for s in (7, 8))
    _, side = qp.phase_probe("qk+sm x2", torch.from_numpy(q).bfloat16(),
                             torch.from_numpy(k).bfloat16(), side=True)
    qb, kb = (torch.from_numpy(a).bfloat16().double().numpy() for a in (q, k))
    want = 0.0
    for h in range(2):
        s = qb[..., 64 * h:64 * (h + 1)] @ kb[..., 64 * h:64 * (h + 1)].transpose(0, 2, 1)
        want = want + np.exp(s - s.max(-1, keepdims=True)).sum(-1)
    assert side.shape == (STEPS, ROWS) and side.dtype == torch.float32
    np.testing.assert_allclose(side.numpy(), want, rtol=1e-5)


def _jax_variant(q, k, v, heads, schedule, jdt):
    """The tool's variant_attention at a small shape: q pre-scaled in its
    dtype, keys padded to 256, the Pallas body per (batch, head pair)."""
    b, s, c = q.shape
    s_pad = 256
    qj = jnp.asarray(q, jdt) * jnp.asarray(64 ** -0.5, jdt)

    def pad(x):
        return jnp.pad(jnp.asarray(x, jdt), [(0, 0), (0, s_pad - s), (0, 0)])

    rows = pl.BlockSpec((1, s_pad, 128), lambda bi, hi, qi: (bi, qi, hi))
    keys = pl.BlockSpec((1, s_pad, 128), lambda bi, hi, qi: (bi, 0, hi))
    out = pl.pallas_call(
        functools.partial(PHASES._variant_kernel, s_actual=s, dh=64, schedule=schedule),
        out_shape=jax.ShapeDtypeStruct((b, s_pad, c), jdt), grid=(b, heads // 2, 1),
        in_specs=[rows, keys, keys], out_specs=rows, interpret=True)(pad(qj), pad(k), pad(v))
    return np.asarray(out[:, :s], np.float32)


@pytest.mark.parametrize("schedule", t2.SCHEDULES)
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 4e-3), ("float32", 1e-5)])
def test_t2_plain_matches_jax_body(schedule, dtype, tol):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 200, 256)).astype(np.float32) for _ in range(3))
    want = _jax_variant(q, k, v, 4, schedule, jdt)
    kernels.reset_launch_counts()
    got = t2.attention_variant(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                               num_heads=4, schedule=schedule)
    assert kernels.launch_counts()["attention_variants"] == 0   # CPU: plain version
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_t2_plain_is_k1_plain_in_fp32():
    """In fp32 the rounded-p denominator is K1's, and q * 64^-0.5 is exact."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 130, 256)).astype(np.float32))
               for _ in range(3))
    torch.testing.assert_close(t2.attention_variant_plain(q, k, v, num_heads=4),
                               spatial_attention_plain(q, k, v, num_heads=4, scale=0.125),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_t2_plain_is_k1_plain_with_mxu_denom(dtype):
    """T2's function is K1's with the rounded-p denominator (mxu_denom=True)
    at scale 1/8, a power of two: fp32 within 1e-6, bf16 within one bf16
    step of max |o|."""
    tdt = DTYPES[dtype][1]
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 130, 256)).astype(np.float32)).to(tdt)
               for _ in range(3))
    got = t2.attention_variant_plain(q, k, v, num_heads=4).float().numpy()
    want = spatial_attention_plain(q, k, v, num_heads=4, scale=0.125,
                                   mxu_denom=True).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        _assert_held(got, want, dtype)


def test_kernel_checks_reject_what_the_kernels_do_not_take():
    """The checks run before any build: fp32, ragged rows and strided
    operands raise (no plain fallback on the card)."""
    q = torch.zeros(2, 128, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        qp._launch_t1(0, q, q, q, None, None)
    with pytest.raises(ValueError, match="M % 64"):
        qp._launch_t1(0, torch.zeros(2, 100, 128, dtype=torch.bfloat16), q.bfloat16(), q, None,
                      None)
    with pytest.raises(TypeError, match="bfloat16"):
        qp._launch_qk(2, q, q, q)
    p = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        qp._launch_pv(p, p.transpose(1, 2), torch.zeros(1, 64, 128, dtype=torch.bfloat16), p)
    x = torch.zeros(1, 10, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        t2._check(x, x, x, 2)
    with pytest.raises(ValueError, match="head dim"):
        t2._check(x.bfloat16(), x.bfloat16(), x.bfloat16(), 4)
    with pytest.raises(ValueError, match="schedule"):
        t2.attention_variant(x, x, x, num_heads=2, schedule="exp2")
    with pytest.raises(ValueError, match="side sum"):
        qp.phase_probe("qk128", q, q, side=True)
    with pytest.raises(ValueError, match="sink"):
        qp.phase_probe("qk+sm x2", q, q, sink=True)


@pytest.mark.parametrize("tool", [bench_kernel_phases, bench_kernel_ab])
def test_tools_exit_2_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 2
    assert tool.main(["nonsense"]) == 2
    assert "nothing was run" in capsys.readouterr().err


@pytest.mark.parametrize("est_ms", [0.192, 0.256, 2.0, 4.0])
def test_chain_lengths_are_the_jax_tools(est_ms):
    """The JAX tools' timed(): c1 = max(4, int(margin / est / 8)), c2 = c1 +
    max(8, int(margin / est)), est in seconds there."""
    est_s = est_ms / 1e3
    c1 = max(4, int(PHASES.TARGET_MARGIN_S / est_s / 8))
    assert timing.chain_lengths(est_ms) == (c1, c1 + max(8, int(PHASES.TARGET_MARGIN_S / est_s)))


def test_tool_shapes_and_bounds_are_the_jax_tools():
    """The port's tools keep the JAX tools' shape; the bounds follow from it."""
    for mod in (PHASES, AB):
        assert (mod.B, mod.S, mod.H, mod.DH, mod.S_PAD) == (
            bench_kernel_phases.B, bench_kernel_phases.S, bench_kernel_phases.H,
            bench_kernel_phases.DH, bench_kernel_phases.S_PAD)
    qk = bench_kernel_phases.probe_cost("qk64x2")
    assert qk["flops"] == 2 * 2 * 1408 * 1408 * 64 * 64       # the JAX flops_per_step x nb
    ms, by = timing.bound_ms(qk["flops"], qk["bytes"])
    assert by == "operations" and abs(ms - 0.0328) < 1e-3
    pv = bench_kernel_phases.probe_cost("pv128x2")
    ms, by = timing.bound_ms(pv["flops"], pv["bytes"])
    assert by == "bytes" and abs(ms - 0.062) < 1e-3
    cost = bench_kernel_phases.attention_cost()
    ms, by = timing.bound_ms(cost["flops"], cost["bytes"])
    # 16 ex2 per SM and clock, 132 SMs, 1.98 GHz: 4.18e12 exponentials/s.
    assert by == "operations" and abs(ms - 0.2487) < 1e-4
    assert abs(timing.exp_ms(cost["exps"]) - 0.2298) < 1e-4
