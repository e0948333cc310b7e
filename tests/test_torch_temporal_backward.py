"""The gradient of K2's temporal attention: the custom op
``vda::temporal_attention_backward`` on the CPU (its plain version, the
plain forward's gradient under autograd) against ``jax.vjp`` of the JAX
package's two temporal forms, ``temporal_flat_attention`` (the TPU path)
and ``temporal_mha`` (the [B, H, T, D] path), on the same numpy inputs.

Tolerance, relative to each gradient's max |g| (floored at 1e-3 of the
largest of the three: at T = 1 the softmax is constant, so dq and dk are
0): fp32 1e-5 (the order of
fp32 sums; temporal_mha scales the fp32 scores where the port pre-scales
q); bf16 2e-2, K2's bf16 tolerance (the two sides round q's pre-scale,
the probabilities and the cotangents at other points). The kernel itself
is held against this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase (n)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from video_depth_anything_tpu.ops.attention import temporal_flat_attention, temporal_mha
from video_depth_anything_torch import kernels
from video_depth_anything_torch.kernels import temporal_attention as k2

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads beside the JAX CPU client's device threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(p, t, c, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((p, t, c)).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, do, heads, scale, dtype, form):
    """dq, dk, dv of the JAX form at (q, k, v) against do, as fp32 numpy."""
    p, t, c = q.shape
    dh = c // heads

    def flat(a, b, e):
        return temporal_flat_attention(a, b, e, num_heads=heads, scale=scale)

    def mha(a, b, e):
        def split(x):
            return x.reshape(p, t, heads, dh).transpose(0, 2, 1, 3)
        o = temporal_mha(split(a), split(b), split(e), scale=scale)
        return o.transpose(0, 2, 1, 3).reshape(p, t, c)

    grads = jax.jit(lambda *x: jax.vjp(flat if form == "flat" else mha, *x[:3])[1](x[3]))
    return [np.asarray(g, np.float32) for g in grads(*(jnp.asarray(x, dtype)
                                                       for x in (q, k, v, do)))]


def _held(got, ref, tol):
    floor = 1e-3 * max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        g = g.float().numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        err = np.abs(g - r).max() / max(np.abs(r).max(), floor)
        assert err <= tol, err


# T in {1, 7, 20, 32} with vits' head dims (8, 24, 48) and vitl's 128 at 8
# heads, and 4 local heads (a (1, 2) mesh's) at three of them.
CASES = ([(t, dh, 8) for t in (1, 7, 20, 32) for dh in (8, 24, 48, 128)]
         + [(20, 24, 4), (32, 48, 4), (7, 8, 4)])


@pytest.mark.parametrize("form", ["flat", "mha"])
@pytest.mark.parametrize("t,dh,heads", CASES)
def test_plain_backward_fp32_matches_jax(t, dh, heads, form):
    q, k, v, do = _inputs(3, t, heads * dh, seed=t * 1000 + dh + heads)
    scale = dh ** -0.5
    kernels.reset_launch_counts()
    got = k2.temporal_attention_backward(*(torch.from_numpy(x) for x in (q, k, v, do)),
                                         num_heads=heads, scale=scale)
    assert kernels.launch_counts()["temporal_attention_backward"] == 0   # CPU: plain version
    _held(got, _jax_grads(q, k, v, do, heads, scale, jnp.float32, form), TOL["float32"])


@pytest.mark.parametrize("form", ["flat", "mha"])
@pytest.mark.parametrize("t,dh,heads", [(20, 24, 8), (32, 8, 8), (7, 128, 4), (1, 48, 8)])
def test_plain_backward_bf16_matches_jax(t, dh, heads, form):
    q, k, v, do = _inputs(4, t, heads * dh, seed=7 + t + dh)
    scale = dh ** -0.5
    got = k2.temporal_attention_backward(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v, do)), num_heads=heads, scale=scale)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _held(got, _jax_grads(q, k, v, do, heads, scale, jnp.bfloat16, form), TOL["bfloat16"])


@pytest.mark.parametrize("need", [(True, False, False), (False, True, True), (True, True, True)])
def test_function_with_some_inputs_requiring_grad_matches_jax(need):
    """Only some of q, k, v require grad: the Function returns their
    gradients (JAX's) and None for the others."""
    t, dh, heads = 20, 24, 8
    x = _inputs(2, t, heads * dh, seed=sum(need))
    a = [torch.from_numpy(y).requires_grad_(n) for y, n in zip(x[:3], need)]
    o = k2.temporal_attention(*a, num_heads=heads, scale=dh ** -0.5)
    o.backward(torch.from_numpy(x[3]))
    ref = _jax_grads(*x, heads, dh ** -0.5, jnp.float32, "flat")
    for u, n, r in zip(a, need, ref):
        assert (u.grad is not None) == n
        if n:
            _held([u.grad], [r], TOL["float32"])


class _Ops(TorchDispatchMode):
    """Records the name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_function_backward_reaches_the_op():
    """The Function's backward dispatches vda::temporal_attention_backward,
    and its gradients are the op's outputs bit for bit."""
    x = [torch.from_numpy(y) for y in _inputs(3, 7, 32, seed=5)]
    a = [y.clone().requires_grad_() for y in x[:3]]
    o = k2.temporal_attention(*a, num_heads=4, scale=0.3)
    with _Ops() as ops:
        o.backward(x[3])
    assert "vda.temporal_attention_backward.default" in ops.names
    want = k2.temporal_attention_backward_op(*x, 4, 0.3)
    for u, w in zip(a, want):
        torch.testing.assert_close(u.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck(dtype):
    x = [torch.from_numpy(y).to(dtype) for y in _inputs(6, 5, 64, seed=9)]
    torch.library.opcheck(k2.temporal_attention_backward_op, (*x, 4, 0.18))


def test_fake_implementation_on_meta_tensors():
    """A shapes-only run: the wrapper takes meta tensors to the op's fake
    implementation, which gives three [P, T, C] gradients in q's dtype."""
    q, k, v, do = (torch.empty(5, 20, 192, device="meta", dtype=torch.bfloat16)
                   for _ in range(4))
    kernels.reset_launch_counts()
    grads = k2.temporal_attention_backward(q, k, v, do, num_heads=8, scale=24 ** -0.5)
    assert [(g.device.type, g.shape, g.dtype) for g in grads] == [
        ("meta", torch.Size([5, 20, 192]), torch.bfloat16)] * 3
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
