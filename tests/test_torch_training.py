"""The port's training path against the JAX package's, on the CPU.

Toy model of tests/test_training.py (embed 64, depth 2, 2 heads, features
32, T = 4, 28^2), JAX weights from ``init_params(0)`` with proj_out and
cls_token perturbed (test_torch_model.perturbed_params), so every head
tensor gets a gradient; they cross into the port with the strict
converter, and JAX gradients / Adam moments cross the same way.

Tolerances:
  - losses: value rtol 1e-5; gradients within 1e-5 of each gradient's max
    |g| (the same masked reductions, other fp32 summation orders);
  - K2's Function: torch.autograd.gradcheck in float64; against JAX's
    motion module, gradients within 1e-4 of each tensor's max |g|;
  - the head's gradient function in float64 (the port's modules and losses
    cast to float64, against JAX under x64): within 1e-4 of each leaf's max
    |g| (measured 2.6e-5: JAX's GroupNorm sums in fp32 even under x64);
  - the fp32 train step: loss 1e-5 relative, head gradients within 2e-4 of
    each leaf's max |g| (measured: up to 1.13e-4, on a LayerNorm weight of a
    motion module, whose gradient is a sum that cancels), Adam's first
    moment within 2e-4 of its leaf's max and the second within 4e-4 (it is
    a square); after three steps the
    parameters within 1e-2 * lr of JAX's (measured 4.5e-3 * lr; a wrong lr,
    decay or beta moves them by a fair share of lr) on the entries whose
    |g| is over
    1e-3 of its leaf's max at every step and where the two gradients agree
    within 1 % of |g|. Adam's first step moves each entry by about
    lr * sign(g), so an entry whose |g| is near rounding may move by +-lr
    between the packages, and so may one a ReLU kink moved (below): those
    entries are left out, and at least 60 % are held (72 % are);
  - bf16: the step's prediction within the bf16 drift budget of
    utils/precision.py against the fp32 one (both packages), the loss
    within 2 % of JAX's bf16 loss.

A ReLU input within fp32 rounding of 0 may fall on the other side in the
other package; the derivative of every tensor upstream then differs by a
whole term (one such input of 16,384 moved layer1_rn's gradient by 2.7 % of
its max on this toy). So the fp32 step's batch is one whose ReLU inputs
all lie at least 1e-6 of their map's max |x| from 0 at the step whose
gradients are compared, which the test asserts (``kink_margin``) rather
than assumes; the float64 test holds the same gradients on a batch
without that margin.
"""
import copy
import dataclasses
import math
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_depth_anything_tpu.config import ModelConfig as JModelConfig
from video_depth_anything_tpu.config import ViTConfig as JViTConfig
from video_depth_anything_tpu.models import video_depth as jvd
from video_depth_anything_tpu.models.motion import temporal_module as j_temporal_module
from video_depth_anything_tpu.training import losses as jlosses
from video_depth_anything_tpu.training import train_state as jts
from video_depth_anything_torch.config import ModelConfig, ViTConfig
from video_depth_anything_torch.convert import model_from_params, state_dict_from_params
from video_depth_anything_torch.kernels.temporal_attention import (
    temporal_attention, temporal_attention_plain)
from video_depth_anything_torch.models import build_model
from video_depth_anything_torch.models.video_depth import finish
from video_depth_anything_torch.ops import nn as vnn
from video_depth_anything_torch.training import checkpoint as ckpt
from video_depth_anything_torch.training import losses
from video_depth_anything_torch.training import train_state as ts
from video_depth_anything_torch.utils.precision import (MAX_ERR_FRAC, MEAN_ERR_FRAC,
                                                        precision_drift_report)

from test_torch_model import perturbed_params

torch.set_num_threads(2)   # beside the JAX CPU client's threads (test_torch_streaming.py)

_KW = dict(encoder="_tiny2", features=32, out_channels=(32, 32, 32, 32), num_frames=4,
           taps=(0, 0, 1, 1))
JCFG = JModelConfig(vit_override=JViTConfig(embed_dim=64, depth=2, num_heads=2), **_KW)
CFG = ModelConfig(vit_override=ViTConfig(embed_dim=64, depth=2, num_heads=2), **_KW)
_TC = dict(learning_rate=3e-3, epochs=1, steps_per_epoch=10, ratio_tgm=1.0)


def tcs(dtype="float32", **kw):
    return (jts.TrainConfig(compute_dtype=dtype, **{**_TC, **kw}),
            ts.TrainConfig(compute_dtype=dtype, **{**_TC, **kw}))


def make_batch(seed=0, b=2, t=4, hw=28, image=False):
    rng = np.random.default_rng(seed)
    batch = {"video": rng.standard_normal((b, t, hw, hw, 3)).astype(np.float32),
             "gt": rng.random((b, t, hw, hw)).astype(np.float32),
             "mask": (rng.random((b, t, hw, hw)) > 0.2).astype(np.float32)}
    if image:
        batch.update(image_video=rng.standard_normal((b, 1, hw, hw, 3)).astype(np.float32),
                     image_gt=rng.random((b, 1, hw, hw)).astype(np.float32),
                     image_mask=(rng.random((b, 1, hw, hw)) > 0.3).astype(np.float32))
    return batch


@pytest.fixture(scope="module")
def params():
    return perturbed_params(JCFG)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def head_sd(tree):
    """A JAX head tree (gradients, moments, parameters) in the port's names."""
    sd = state_dict_from_params({"head": jax.tree.map(np.asarray, tree)}, CFG.vit.depth)
    return {k[len("head."):]: v.numpy() for k, v in sd.items()}


def close_to_leaf_max(got, ref, frac, name="", floor=1e-30):
    """|got - ref| <= frac * max(max |ref|, floor). ``floor``: for a leaf
    whose gradient is 0 in JAX (a GroupNorm over one pixel per group
    normalises to 0), a scale taken from the other leaves."""
    scale = max(float(np.abs(ref).max()), floor)
    err = float(np.abs(got - ref).max())
    assert err <= frac * scale, f"{name}: max err {err:.3e} > {frac} x max |ref| {scale:.3e}"


# ---------------------------------------------------------------- losses


def loss_inputs():
    """pred / gt / mask [2, 4, 8, 10] with every kink the losses have: exact
    zeros in pred (ties, and |0| residuals), frames 1 and 2 of batch 0 equal
    (TGM differences exactly 0), gt quantised to 1/16 (ties), a fully masked
    frame and a frame with one valid pixel."""
    rng = np.random.default_rng(7)
    pred = rng.standard_normal((2, 4, 8, 10)).astype(np.float32)
    pred[rng.random(pred.shape) < 0.15] = 0.0
    pred[0, 2] = pred[0, 1]
    gt = (np.round(rng.random((2, 4, 8, 10)) * 16) / 16).astype(np.float32)
    gt[0, 2] = gt[0, 1]
    mask = (rng.random((2, 4, 8, 10)) > 0.25).astype(np.float32)
    mask[1, 3] = 0.0
    mask[1, 0] = 0.0
    mask[1, 0, 3, 4] = 1.0
    return pred, gt, mask


LOSSES = {
    "ssi_loss_median": (jlosses.ssi_loss_median, losses.ssi_loss_median),
    "ssi_loss_lstsq": (jlosses.ssi_loss_lstsq, losses.ssi_loss_lstsq),
    "ssi_mse_loss": (jlosses.ssi_mse_loss, losses.ssi_mse_loss),
    "tgm_loss": (jlosses.tgm_loss, losses.tgm_loss),
    "combined_lstsq": (lambda p, g, m: jlosses.combined_loss(p, g, m)[0],
                       lambda p, g, m: losses.combined_loss(p, g, m)[0]),
    "combined_median": (lambda p, g, m: jlosses.combined_loss(p, g, m, ssi_variant="median")[0],
                        lambda p, g, m: losses.combined_loss(p, g, m, ssi_variant="median")[0]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name):
    jfn, tfn = LOSSES[name]
    pred, gt, mask = loss_inputs()
    jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    p = torch.from_numpy(pred).requires_grad_()
    val = tfn(p, torch.from_numpy(gt), torch.from_numpy(mask))
    val.backward()
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    close_to_leaf_max(p.grad.numpy(), np.asarray(jgrad), 1e-5, name)


def test_median_kinks_are_jax_s():
    """The derivative at the median pixel is JAX's (+1 from |0|, where
    torch.abs gives 0): a row whose median is unique gives a different
    gradient with torch.abs, and the port's equals JAX's."""
    pred, gt, mask = loss_inputs()
    ref = np.asarray(jax.grad(jlosses.ssi_loss_median)(*(jnp.asarray(a) for a in (pred, gt, mask))))
    p = torch.from_numpy(pred).requires_grad_()
    saved = losses._abs
    try:
        losses._abs = torch.abs
        losses.ssi_loss_median(p, torch.from_numpy(gt), torch.from_numpy(mask)).backward()
    finally:
        losses._abs = saved
    assert np.abs(p.grad.numpy() - ref).max() > 1e-3 * np.abs(ref).max()
    empty = losses._masked_median(torch.zeros(1, 5), torch.zeros(1, 5, dtype=torch.bool))
    assert float(empty[0][0]) == 0.0 and int(empty[1][0]) == 0


# ---------------------------------------------------------------- K2's gradient


def test_k2_function_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 5, 8, generator=gen, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    fn = lambda a, b, c: temporal_attention(a, b, c, num_heads=2, scale=0.5)  # noqa: E731
    assert fn(q, k, v).grad_fn.name().startswith("TemporalAttentionFunction")
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-8, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_function_equals_plain_autograd(dtype):
    """The Function's output and dq / dk / dv are the plain version's under
    autograd, bit for bit on the CPU (only some of q, k, v requiring grad)."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(6, 4, 16, generator=gen).to(dtype) for _ in range(3))
    do = torch.randn(6, 4, 16, generator=gen).to(dtype)
    for need in ((True, True, True), (False, True, False)):
        a = [x.clone().requires_grad_(n) for x, n in zip((q, k, v), need)]
        b = [x.clone().requires_grad_(n) for x, n in zip((q, k, v), need)]
        o1 = temporal_attention(*a, num_heads=4, scale=0.5)
        o2 = temporal_attention_plain(*b, num_heads=4, scale=0.5)
        torch.testing.assert_close(o1, o2, rtol=0, atol=0)
        o1.backward(do)
        o2.backward(do)
        for x, y in zip(a, b):
            assert (x.grad is None) == (y.grad is None)
            if x.grad is not None:
                torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=0)
    with torch.no_grad():   # the inference path calls the bare launch
        assert temporal_attention(q.requires_grad_(), k, v, num_heads=4, scale=0.5).grad_fn is None


def test_motion_module_gradient_matches_jax(params):
    p = params["head"]["motion_modules"]["0"]
    b, t = 1, 4
    x = np.random.default_rng(3).standard_normal((b * t, 3, 5, 32)).astype(np.float32)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(j_temporal_module(p, x, b, t) * cot)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jtree(p), jnp.asarray(x))
    model = model_from_params(params, CFG)
    mod = model.head.motion_modules[0].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    (mod(xt, b, t) * torch.from_numpy(cot)).sum().backward()
    close_to_leaf_max(xt.grad.numpy(), np.asarray(jgx), 1e-4, "x")
    ref = head_sd({"motion_modules": {"0": jgp}})
    for name, prm in mod.named_parameters():
        close_to_leaf_max(prm.grad.numpy(), ref["motion_modules.0." + name], 1e-4, name)
    pe = mod.temporal_transformer.transformer_blocks[0].attention_blocks[0].pos_encoder.pe
    assert not pe.requires_grad   # a buffer of the module; TrainState trains it


# ---------------------------------------------------------------- the train step


def port_state(params, tc, cfg=CFG):
    return ts.create_train_state(model_from_params(params, cfg), tc)


_jax_value_and_grad = jax.jit(jax.value_and_grad(jts.loss_fn, has_aux=True),
                              static_argnums=(3, 4))


def jax_grads(params, batch, jcfg, jtc):
    (loss, _), g = _jax_value_and_grad(
        jtree(params["head"]), jtree(params["pretrained"]), jtree(batch), jcfg, jtc)
    return float(loss), head_sd(g)


@contextmanager
def kink_margin(margins: list):
    """Record, for every ReLU input with negative entries (a pre-activation),
    its least nonzero |x| over its max |x| into ``margins``."""
    real = vnn.relu

    def relu(x):
        if (x < 0).any():
            a = x.detach().abs()
            margins.append(float(a[a > 0].min() / a.max()))
        return real(x)

    vnn.relu = relu
    try:
        yield
    finally:
        vnn.relu = real


def test_head_gradient_float64_matches_jax(params):
    """The loss's gradient over the head, every tensor in float64 on both
    sides: the port's modules, resize and losses against JAX under x64."""
    batch = make_batch()
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32
                           else jnp.asarray(a), params)
        b64 = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}

        def jloss(head):
            pred = jvd.forward({"pretrained": p64["pretrained"], "head": head}, b64["video"],
                               JCFG, train=True)
            return jlosses.combined_loss(pred, b64["gt"], b64["mask"], ratio_tgm=1.0)[0]

        jl, jg = jax.jit(jax.value_and_grad(jloss))(p64["head"])
        jl, jg = float(jl), head_sd(jax.tree.map(lambda a: np.asarray(a, np.float32), jg))
    loss, grads = head_grads(model_from_params(params, CFG), batch, CFG, torch.float64,
                             ratio_tgm=1.0)
    np.testing.assert_allclose(loss, jl, rtol=1e-6)
    for name, ref in jg.items():
        close_to_leaf_max(grads[name].numpy(), ref, 1e-4, name,
                          floor=1e-3 * max(np.abs(v).max() for v in jg.values()))


def head_grads(model, batch, cfg, dtype, **loss_kw):
    """The combined loss and its gradient over every head tensor, the whole
    model (the APE tables too) and the batch cast to ``dtype``; a tensor
    the forward never reaches gets zeros."""
    model = copy.deepcopy(model).to(dtype)
    for m in model.head.modules():
        for k, b in m._buffers.items():
            if b is not None and b.is_floating_point():
                m._buffers[k] = b.to(dtype)
    trained = {n: t.requires_grad_(True) for n, t in model.head.state_dict(keep_vars=True).items()
               if t.is_floating_point()}
    x, gt, mask = (torch.as_tensor(batch[k]).to(dtype) for k in ("video", "gt", "mask"))
    b, t, h, w, _ = x.shape
    with torch.no_grad():
        feats = model.pretrained.get_intermediate_layers(x.reshape(b * t, h, w, 3),
                                                         cfg.intermediate_layer_idx)
    pred = finish(model.head(feats, h // 14, w // 14, b, t, train=True), b, t, h, w)
    loss = losses.combined_loss(pred, gt, mask, **loss_kw)[0]
    loss.backward()
    return float(loss), {n: torch.zeros_like(p) if p.grad is None else p.grad.detach()
                         for n, p in trained.items()}


def test_shared_kinks_leave_rounding_only():
    """tools/bench_train_step.py's clip and weights (vits, 8 frames at
    56^2, lstsq SSI + 10 TGM): the fp32 gradient, its kink sides replayed
    on a float64 evaluation (utils/kinks.py), within 1e-4 of each leaf's
    max of it (measured 2.9e-5), every moved side at an input within 1e-5
    of its map's max |x| of 0."""
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.tools.bench_train_step import (synthetic_batch,
                                                                   synthetic_model)
    from video_depth_anything_torch.utils import kinks

    cfg = get_model_config("vits", num_frames=8)
    model = synthetic_model(cfg, 0)
    batch = synthetic_batch(1, 8, 56, "cpu", seed=3)
    log, flips = [], []
    with kinks.record(log):
        _, g32 = head_grads(model, batch, cfg, torch.float32)
    with kinks.replay(log, flips):
        _, g64 = head_grads(model, batch, cfg, torch.float64)
    gmax = max(g.abs().max().item() for g in g64.values())
    for name, g in g64.items():
        close_to_leaf_max(g32[name].double().numpy(), g.numpy(), 1e-4, name, 1e-3 * gmax)
    assert len(flips) == len(log) and max(r for _, r in flips) <= 1e-5


def test_trained_tensors_are_jax_s_head(params):
    state = port_state(params, tcs()[1])
    assert sorted(state.head) == sorted(head_sd(params["head"]))
    assert not any(p.requires_grad for p in state.model.pretrained.parameters())


def test_fp32_step_matches_jax(params):
    jtc, tc = tcs()
    batch = make_batch(1)
    jstate = jts.create_train_state(jtree(params), jtc)
    state = port_state(params, tc)
    mask_ok = {n: np.ones(v.shape, bool) for n, v in head_sd(params["head"]).items()}
    for step in range(3):
        jloss, jg = jax_grads(jax.tree.map(np.asarray, jstate.params), batch, JCFG, jtc)
        jstate, jm = jts.train_step(jstate, jtree(batch), JCFG, jtc)
        margins: list = []
        with kink_margin(margins):
            state, m = ts.train_step(state, batch, CFG, tc)
        if step == 0:
            assert min(margins) >= 1e-6, min(margins)
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
        np.testing.assert_allclose(float(jm["loss"]), jloss, rtol=1e-6)
        floor = 1e-3 * max(np.abs(v).max() for v in jg.values())
        for name, t in state.head.items():
            g = t.grad.numpy()
            if step == 0:
                close_to_leaf_max(g, jg[name], 2e-4, name, floor)
            mask_ok[name] &= np.abs(jg[name]) > 1e-3 * np.abs(jg[name]).max()
            mask_ok[name] &= np.abs(g - jg[name]) <= 1e-2 * np.abs(jg[name])
        if step == 0:
            mu, nu = head_sd(jstate.opt_state[0].mu), head_sd(jstate.opt_state[0].nu)
            for name, t in state.head.items():
                st = state.opt.state[t]
                close_to_leaf_max(st["exp_avg"].numpy(), mu[name], 2e-4, name + " mu", 0.1 * floor)
                close_to_leaf_max(st["exp_avg_sq"].numpy(), nu[name], 4e-4, name + " nu",
                                  1e-3 * floor ** 2)
    assert state.step == int(jstate.step) == 3
    jhead = head_sd(jstate.params["head"])
    checked = 0
    for name, t in state.head.items():
        ok = mask_ok[name]
        got, ref = t.detach().numpy()[ok], jhead[name][ok]
        if got.size:
            assert np.abs(got - ref).max() <= 1e-2 * tc.learning_rate, name
        checked += ok.sum()
    assert checked > 0.6 * sum(v.size for v in mask_ok.values())


def test_image_video_branch_matches_jax(params):
    jtc, tc = tcs()
    batch = make_batch(1, b=1, image=True)
    jloss, jg = jax_grads(params, batch, JCFG, jtc)
    state = port_state(params, tc)
    with torch.enable_grad():
        loss, aux = ts.loss_fn(state, batch, CFG, tc)
        loss.backward()
    assert set(aux) == {"ssi", "tgm", "ssi_image"}
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    floor = 1e-3 * max(np.abs(v).max() for v in jg.values())
    for name, t in state.head.items():
        g = np.zeros_like(jg[name]) if t.grad is None else t.grad.numpy()
        close_to_leaf_max(g, jg[name], 2e-4, name, floor)


def test_bf16_step_within_drift_budget(params):
    jtc, tc = tcs("bfloat16")
    _, tc32 = tcs()
    batch = make_batch(2)
    jstate, jm = jts.train_step(jts.create_train_state(jtree(params), jtc), jtree(batch), JCFG, jtc)
    state = port_state(params, tc)
    with torch.no_grad():
        video = torch.from_numpy(batch["video"])
        pred16 = ts.forward(state, video, CFG, train=True).numpy()
        pred32 = ts.forward(port_state(params, tc32), video, CFG, train=True).numpy()
    jfwd = jax.jit(lambda p, v: jvd.forward(p, v, JCFG, train=True))
    jpred16 = np.asarray(jfwd(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jtree(params)),
                              jnp.asarray(batch["video"], jnp.bfloat16)))
    for cand in (pred16, jpred16):
        rep = precision_drift_report(cand, pred32)
        assert rep["max_err_frac"] < MAX_ERR_FRAC and rep["mean_err_frac"] < MEAN_ERR_FRAC, rep
    state, m = ts.train_step(state, batch, CFG, tc)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-2)
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in state.head.values())
    assert next(state.encoder.parameters()).dtype == torch.bfloat16


def test_batchnorm_stats_trained_as_jax_and_encoder_frozen():
    """use_bn: the BatchNorm running mean and variance are head leaves in
    JAX, differentiated and moved by AdamW; the port trains them the same
    way (gradients within 2e-4 of each leaf's max, as the fp32 step), keeps
    BatchNorm out of torch's train mode and the encoder bit for bit."""
    jcfg, cfg = dataclasses.replace(JCFG, use_bn=True), dataclasses.replace(CFG, use_bn=True)
    jtc, tc = tcs()
    jparams = perturbed_params(jcfg)
    batch = make_batch(1)
    jloss, jg = jax_grads(jparams, batch, jcfg, jtc)
    state = port_state(jparams, tc, cfg)
    stats = [n for n in state.head if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 2 * 2 * 4
    assert sorted(state.head) == sorted(n for n in jg if not n.endswith("num_batches_tracked"))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, m = ts.train_step(state, batch, cfg, tc)
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
    floor = 1e-3 * max(np.abs(v).max() for v in jg.values())
    for name in stats:
        close_to_leaf_max(state.head[name].grad.numpy(), jg[name], 2e-4, name, floor)
    after = state.model.state_dict()
    for k, v in before.items():
        if k.startswith("pretrained.") or k.endswith("num_batches_tracked"):
            assert torch.equal(v, after[k]), k
    assert not state.model.training
    still = [k for k in state.head if torch.equal(before["head." + k], after["head." + k])]
    # Every trained tensor moves (APE tables, BN statistics) but the zeros
    # of refinenet4's unreached first unit (gradient 0, decay keeps 0).
    assert all(k.startswith("scratch.refinenet4.resConfUnit1.") and not before["head." + k].any()
               for k in still), still


def test_cosine_lr_equals_optax():
    _, tc = tcs(epochs=3, steps_per_epoch=8)
    sched = optax.cosine_decay_schedule(tc.learning_rate, tc.epochs * tc.steps_per_epoch,
                                        alpha=tc.eta_min / tc.learning_rate)
    horizon = tc.epochs * tc.steps_per_epoch
    for t in (0, 1, horizon // 2, horizon, horizon + 5):
        np.testing.assert_allclose(ts.cosine_lr(tc, t), float(sched(t)), rtol=2e-6)
    assert math.isclose(ts.cosine_lr(tc, horizon + 5), tc.eta_min, rel_tol=1e-9)


def test_optimizer_runs_at_the_schedule(params):
    _, tc = tcs(epochs=1, steps_per_epoch=4)
    state = port_state(params, tc)
    batch = make_batch(4)
    for step in range(3):
        state, _ = ts.train_step(state, batch, CFG, tc)
        assert state.opt.param_groups[0]["lr"] == ts.cosine_lr(tc, step)


def test_checkpoint_roundtrip_and_resume(params, tmp_path):
    _, tc = tcs()
    batch = make_batch(5)
    state = port_state(params, tc)
    state, _ = ts.train_step(state, batch, CFG, tc)
    extra = {"epoch": 3, "best_val_loss": 0.5, "trial": 1}
    ckpt.save_checkpoint(str(tmp_path), "latest_checkpoint", state, extra)
    assert ckpt.latest_exists(str(tmp_path))
    assert ckpt.load_checkpoint(str(tmp_path), "best_checkpoint") is None
    # A fresh state from other weights, restored: the continuation equals
    # the unsaved one bit for bit.
    other = ts.create_train_state(build_model(CFG, seed=5), tc)
    restored = ckpt.load_checkpoint(str(tmp_path), "latest_checkpoint", template=other)
    assert restored["extra"] == extra and other.step == 1
    state, m1 = ts.train_step(state, batch, CFG, tc)
    other, m2 = ts.train_step(other, batch, CFG, tc)
    assert float(m1["loss"]) == float(m2["loss"]) and other.step == 2
    sd1, sd2 = state.model.state_dict(), other.model.state_dict()
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    for a, b in zip(state.head.values(), other.head.values()):
        s1, s2 = state.opt.state[a], other.opt.state[b]
        assert torch.equal(s1["exp_avg"], s2["exp_avg"]) and torch.equal(s1["exp_avg_sq"],
                                                                           s2["exp_avg_sq"])
    other, m3 = ts.train_step(other, batch, CFG, tc)
    assert torch.isfinite(m3["loss"]) and other.step == 3   # it trains on


def test_eval_step_has_no_gradient(params):
    _, tc = tcs()
    state = port_state(params, tc)
    out = ts.eval_step(state, make_batch(6), CFG, tc)
    assert set(out) == {"loss", "ssi", "tgm"} and out["loss"].grad_fn is None
    assert all(t.grad is None for t in state.head.values())


# ---------------------------------------------------------------- the training driver (training/train.py)


def _driver_yaml(path, epochs, patience=5):
    path.write_text(
        f"hyper_parameter:\n  learning_rate: 1.0e-3\n  epochs: {epochs}\n"
        f"  ratio_ssi: 1\n  ratio_tgm: 1\n  patient: {patience}\n  batch_size: 1\n"
        "  compute_dtype: float32\n")
    return str(path)


DRIVER_CFG = dataclasses.replace(CFG, num_frames=3)


@pytest.fixture(scope="module")
def vkitti_root(tmp_path_factory):
    from test_data import _make_vkitti

    root = str(tmp_path_factory.mktemp("vkitti"))
    _make_vkitti(root, frames=4, hw=(40, 60))
    return root


def test_driver_end_to_end_and_resume(vkitti_root, tmp_path):
    import json
    import os

    from video_depth_anything_torch.training.train import train

    out = str(tmp_path / "out")
    state = train(_driver_yaml(tmp_path / "a.yaml", 2), data_root=vkitti_root, out_dir=out,
                  max_steps=2, model_cfg=DRIVER_CFG, resize_size=28, device="cpu")
    assert state.step == 2
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert {"step", "train_loss", "epoch"} <= set(recs[0])
    assert any({"val_loss", "absrel", "delta1", "tae", "epoch"} <= set(r) for r in recs)
    assert all(np.isfinite(v) for r in recs for v in r.values())
    for name in ("latest_checkpoint", "best_checkpoint"):
        assert os.path.exists(os.path.join(out, name))
    assert any(v.endswith(".png") for v in os.listdir(os.path.join(out, "val_vis")))

    # Resume continues from the saved epoch with its counters.
    state = train(_driver_yaml(tmp_path / "b.yaml", 3), data_root=vkitti_root, out_dir=out,
                  max_steps=1, model_cfg=DRIVER_CFG, resize_size=28, resume=True, device="cpu")
    recs2 = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert len(recs2) > len(recs) and state.step == 3
    extra = ckpt.load_checkpoint(out, "latest_checkpoint")["extra"]
    vals = {int(r["epoch"]): r["val_loss"] for r in recs2 if "val_loss" in r}
    upto = {e: v for e, v in vals.items() if e <= int(extra["epoch"])}
    best = min(upto.values())
    assert float(extra["best_val_loss"]) == pytest.approx(best)
    assert int(extra["trial"]) == int(extra["epoch"]) - min(e for e, v in upto.items() if v == best)


def test_driver_patience_and_cosine_horizon(vkitti_root, tmp_path, monkeypatch, capsys):
    """Validation losses that only rise stop the run after ``patient``
    epochs; the cosine horizon is epochs x the loader's real length."""
    import json
    import os

    from video_depth_anything_torch.data import DataLoader, VKITTIVideoDataset
    from video_depth_anything_torch.training.train import train

    seen, calls = {}, []
    real_step, real_eval = ts.train_step, ts.eval_step

    def spy(state, batch, cfg, tc, phase=None):
        seen["tc"] = tc
        return real_step(state, batch, cfg, tc, phase)

    def rising(state, batch, cfg, tc):
        calls.append(1)
        return {**real_eval(state, batch, cfg, tc), "loss": torch.tensor(float(len(calls)))}

    monkeypatch.setattr(ts, "train_step", spy)
    monkeypatch.setattr(ts, "eval_step", rising)
    out = str(tmp_path / "out")
    train(_driver_yaml(tmp_path / "p.yaml", 6, patience=2), data_root=vkitti_root, out_dir=out,
          model_cfg=DRIVER_CFG, resize_size=28, device="cpu")
    assert "early stop at epoch 2 (patience 2)" in capsys.readouterr().out
    epochs = {int(r["epoch"]) for r in map(json.loads, open(os.path.join(out, "metrics.jsonl")))}
    assert epochs == {0, 1, 2}
    n = len(DataLoader(VKITTIVideoDataset(vkitti_root, clip_len=3, split="train",
                                          resize_size=28), batch_size=1))
    assert n > 0 and seen["tc"].steps_per_epoch == n and seen["tc"].epochs == 6


def test_driver_refuses_distributed(vkitti_root, tmp_path, monkeypatch):
    """Neither data parallelism (tests/test_torch_parallel.py) nor the
    model axis (tests/test_torch_tensor_parallel.py) is refused any more.
    On a (1, 2) mesh, global rank 1 sits at data index 0: train() cuts
    the training set by the data axis (one shard, its index 0), not by the
    global rank (two shards, index 1), so both ranks of the model group
    load the same rows."""
    import types

    import torch.distributed as dist

    from video_depth_anything_torch import data
    from video_depth_anything_torch.training.train import train

    class Stop(Exception):
        pass

    seen = []

    def loader(dataset, **kw):
        seen.append(kw)
        raise Stop

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda d: (1, 2)[d],
                                 get_local_rank=lambda name: {"data": 0, "model": 1}[name],
                                 device_type="cpu")
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(data, "DataLoader", loader)
    with pytest.raises(Stop):
        train(_driver_yaml(tmp_path / "dp.yaml", 1), data_root=vkitti_root,
              mesh=mesh, model_cfg=DRIVER_CFG, resize_size=28, device="cpu")
    assert seen == [{"batch_size": 1, "shuffle": True, "num_shards": 1, "shard_id": 0}]


def test_state_from_a_moved_trained_model(params):
    """A model whose APE tables required grad, moved (a non-leaf buffer),
    still makes a state whose every trained tensor is a leaf."""
    _, tc = tcs()
    first = port_state(params, tc)
    moved = copy.deepcopy(first.model).to(torch.float64).to(torch.float32)
    state = ts.create_train_state(moved, tc)
    assert all(t.is_leaf and t.requires_grad for t in state.head.values())
    state, m = ts.train_step(state, make_batch(7), CFG, tc)
    assert torch.isfinite(m["loss"])
