"""Training state and the train / eval steps (the port of the JAX
package's ``training/train_state.py``).

The encoder is frozen and runs under ``torch.no_grad()`` (kernel K1, no
gradient); the head is trained with AdamW and a cosine learning rate on
the SSI (+ TGM) disparity loss, its motion modules running kernel K2 under
a gradient (``kernels/temporal_attention.py``).

Mixed precision as JAX does it: the master head is fp32, and every fp32
tensor of the model is cast to the compute dtype inside the
differentiated function (``torch.func.functional_call`` on the cast head),
so the gradient reaching a master is the compute-dtype gradient cast to
fp32. The frozen encoder is cast once. The forward is ``train=True`` (the
output head's full fp32 island); the loss is fp32.

What is trained: every floating tensor of the head's state dict, which is
JAX's ``params["head"]``: the APE tables, and with ``use_bn`` the
BatchNorm running mean and variance, which JAX's ``_batch_norm`` reads in
inference form as leaves of the differentiated tree, so AdamW moves them
by their gradient. BatchNorm is never put in torch's train mode (no batch
statistics, no running update). The RoPE table is no parameter. A
tensor the forward never reaches (refinenet4's first residual unit, unused
as in the reference) gets a zero gradient, so AdamW decays it as optax
decays it.

AdamW is ``torch.optim.AdamW(lr, (0.9, 0.999), eps 1e-8, weight_decay)``,
algebraically ``optax.adamw`` (decay on every trained tensor, biases
included). The learning rate is optax's ``cosine_decay_schedule`` at the
optimizer's count, computed from ``state.step`` at each step, so a resumed
run continues exactly.

Data parallelism (``shard_train_state(state, mesh)``, JAX's
``shard_train_state``): every rank holds the whole state, rank 0's after a
broadcast, and feeds its own rows of the global batch. After the backward
the head's master gradients are all-reduced (one flattened fp32 buffer,
SUM, then / world) and the reported losses are the ranks' mean. Every loss
is a mean over per-sample terms of equal weight ([B, T] frames, [B, T - 1]
pairs; ``losses.py``), so with equal shards the mean of the ranks' losses
is the loss of the global batch and the mean of their gradients its
gradient. The head is not wrapped in DDP: it runs through
``functional_call`` on cast tensors, which DDP's module hooks do not see.
BatchNorm never runs in train mode, so no batch statistic needs a sync.

The model axis (a mesh wider than 1 on "model"): ``shard_train_state``
broadcasts the whole state from rank 0, then keeps this rank's shard of
every split tensor (``parallel.split_params``: the encoder's heads and
MLP hidden, the motion modules' q / k / v and GEGLU hidden) and of
AdamW's two moments with it, as JAX puts mu and nu on the head's
shardings. The ranks of a model group take the same rows and see the same
loss; a head tensor left whole gets its full gradient on every rank
through the split blocks' ``copy_to_model``, so the gradient mean is over
"data". Those whole tensors' gradients are then averaged over "model" as
well: equal in exact arithmetic, they can differ in their last bits where
a backward kernel sums with atomics (cuDNN's weight gradients), and the
ranks must apply the same update or their copies drift apart.
``state_dict()`` then gathers the whole state on every rank (a
collective), so a checkpoint holds whole tensors and loads into a model
without a mesh.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Callable

import torch
from torch.func import functional_call

from ..config import ModelConfig
from ..models.video_depth import finish
from ..utils import profiling
from . import losses

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """configs/config.yaml's hyper-parameters; JAX's ``TrainConfig``."""
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    epochs: int = 500
    steps_per_epoch: int = 100
    clip_len: int = 20
    ratio_ssi: float = 1.0
    ratio_tgm: float = 10.0
    ratio_ssi_image: float = 0.5
    ssi_variant: str = "lstsq"
    eta_min: float = 1e-6
    compute_dtype: str = "bfloat16"


def cosine_lr(tc: TrainConfig, count: int) -> float:
    """optax.cosine_decay_schedule(learning_rate, epochs * steps_per_epoch,
    alpha=eta_min / learning_rate) at ``count`` (0 at the first step)."""
    decay = max(tc.epochs * tc.steps_per_epoch, 1)
    alpha = tc.eta_min / tc.learning_rate
    cos = 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))
    return tc.learning_rate * ((1.0 - alpha) * cos + alpha)


def make_optimizer(tc: TrainConfig, params) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=cosine_lr(tc, 0), betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=tc.weight_decay)


class TrainState:
    """step, the model (fp32 master head and frozen fp32 encoder, in eval
    mode), the encoder cast to the compute dtype, and AdamW's state over
    the trained head tensors (``self.head``, name -> tensor)."""

    def __init__(self, model, tc: TrainConfig):
        self.model = model.eval()
        self.dtype = _DTYPES[tc.compute_dtype]
        self.step = 0
        self.mesh = None      # set by shard_train_state
        self.split = None     # on a model axis: the names of the split head tensors
        model.requires_grad_(False)
        for m in model.head.modules():   # a buffer moved while it required grad is no leaf
            for k, b in m._buffers.items():
                if b is not None and b.grad_fn is not None:
                    m._buffers[k] = b.detach()
        self.head = {n: t for n, t in model.head.state_dict(keep_vars=True).items()
                     if t.is_floating_point()}
        for t in self.head.values():
            t.requires_grad_(True)
        self.opt = make_optimizer(tc, list(self.head.values()))
        self._cast_encoder()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _cast_encoder(self) -> None:
        enc = self.model.pretrained
        self.encoder = enc if self.dtype == torch.float32 else copy.deepcopy(enc).to(self.dtype)

    def cast_head(self) -> dict:
        """Every floating tensor of the head's state dict in the compute
        dtype (the trained ones differentiably)."""
        return {n: t.to(self.dtype) for n, t in
                self.model.head.state_dict(keep_vars=True).items() if t.is_floating_point()}

    def state_dict(self) -> dict:
        """step, the model's whole tensors and AdamW's state. On a model
        axis the split tensors and moments are gathered: every rank of the
        mesh must call it."""
        from ..parallel import gather_params, model_axis
        from ..parallel.mesh import gather_shard

        axis = model_axis(self.mesh)
        opt = self.opt.state_dict()
        if axis is None:
            return {"step": self.step, "params": self.model.state_dict(), "opt_state": opt}
        specs = _head_specs(self)
        for i, name in enumerate(self.head):
            if name in specs and i in opt["state"]:
                opt["state"][i] = {k: gather_shard(v, *specs[name], axis) if k in _MOMENTS
                                   else v for k, v in opt["state"][i].items()}
        return {"step": self.step, "params": gather_params(self.model, self.mesh),
                "opt_state": opt}

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict`` (the tensors are copied into this
        state's own, so the optimizer keeps hold of them). Whole tensors
        only: restore before ``shard_train_state``."""
        if self.split:
            raise ValueError("restore the whole state first, then shard_train_state")
        self.model.load_state_dict(sd["params"], strict=True)
        self.opt.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])
        self._cast_encoder()


def create_train_state(model, tc: TrainConfig) -> TrainState:
    """``model``: a VideoDepthAnything (``models.build_model``) on its device."""
    return TrainState(model, tc)


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _head_specs(state: TrainState) -> dict:
    """{head tensor name: (dim, groups)} of the head's split tensors."""
    from ..parallel import split_specs

    return {k[len("head."):]: v for k, v in split_specs(state.model).items()
            if k.startswith("head.")}


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """Put ``state`` on ``mesh``, in place: the model (fp32 master head
    with its BatchNorm statistics, frozen encoder), AdamW's moments and
    step counters, and the step, all rank 0's; then, on a model axis,
    this rank's shard of the split tensors and of their moments. Run it
    at creation and after a resume (a whole state); train_step then
    averages gradients over the data axis."""
    from ..parallel import broadcast_, model_axis, shard_params
    from ..parallel.mesh import shard_tensor

    if state.split:
        raise ValueError("the state is already split over a model axis")
    moments = [v for t in state.head.values() for v in state.opt.state.get(t, {}).values()]
    step = torch.tensor([state.step], dtype=torch.int64)
    broadcast_(moments + [step], mesh)
    state.step = int(step)
    shard_params(state.model, mesh)
    axis = model_axis(mesh)
    specs = _head_specs(state)
    for name, (dim, groups) in specs.items():
        st = state.opt.state.get(state.head[name], {})
        for k in _MOMENTS:
            if k in st:
                st[k] = shard_tensor(st[k], dim, groups, axis.size, axis.rank)
    state.mesh = mesh
    state.split = set(specs) if axis is not None else None
    state._cast_encoder()
    return state


def _mean_over(tensors, mesh, axis: str = "data") -> None:
    """Every tensor replaced in place by its mean over one axis of the mesh:
    one flattened buffer, all-reduced as a SUM, then divided by the axis
    size."""
    import torch.distributed as dist

    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    flat /= mesh.size(mesh.mesh_dim_names.index(axis))
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device, dtype=dtype)


def forward(state: TrainState, video: torch.Tensor, cfg: ModelConfig, train: bool = False,
            phase: Callable[[str], None] | None = None) -> torch.Tensor:
    """The model at the compute dtype: video [B, T, H, W, 3] -> depth
    [B, T, H, W] fp32. The encoder without a gradient; the head through
    ``functional_call`` on the cast tensors (differentiable under grad
    mode). ``phase`` is called with "encoder" and "head" as each begins."""
    b, t, h, w, _ = video.shape
    p = cfg.vit.patch_size
    x = video.to(state.dtype).reshape(b * t, h, w, 3)
    if phase:
        phase("encoder")
    with torch.no_grad():
        feats = state.encoder.get_intermediate_layers(x, cfg.intermediate_layer_idx)
    if phase:
        phase("head")
    depth = functional_call(state.model.head, state.cast_head(), (feats, h // p, w // p, b, t),
                            {"train": train})
    return finish(depth, b, t, h, w)


def loss_fn(state: TrainState, batch: dict, cfg: ModelConfig, tc: TrainConfig,
            phase: Callable[[str], None] | None = None):
    """-> (total, {"ssi", "tgm"[, "ssi_image"]}); JAX's ``loss_fn``. The
    spans ``vda.train.inputs`` and ``vda.train.loss`` around the model's."""
    dev = state.device
    with profiling.span("vda.train.inputs"):
        video = _tensor(batch["video"], dev)
    pred = forward(state, video, cfg, train=True, phase=phase)
    with profiling.span("vda.train.loss"):
        gt = _tensor(batch["gt"], dev, torch.float32)
        total, aux = losses.combined_loss(pred, gt, _tensor(batch["mask"], dev),
                                          ratio_ssi=tc.ratio_ssi, ratio_tgm=tc.ratio_tgm,
                                          ssi_variant=tc.ssi_variant)
    if "image_video" in batch:
        # The single-image SSI branch of the combined dataset.
        with profiling.span("vda.train.inputs"):
            image_video = _tensor(batch["image_video"], dev)
        ipred = forward(state, image_video, cfg, train=True, phase=phase)
        with profiling.span("vda.train.loss"):
            imask = _tensor(batch["image_mask"], dev)
            im = imask.to(torch.float32)
            ssi_fn = (losses.ssi_loss_lstsq if tc.ssi_variant == "lstsq"
                      else losses.ssi_loss_median)
            l_img = ssi_fn(ipred * im, _tensor(batch["image_gt"], dev, torch.float32) * im,
                           imask)
            total = total + tc.ratio_ssi_image * l_img
        aux = {**aux, "ssi_image": l_img}
    return total, aux


def train_step(state: TrainState, batch: dict, cfg: ModelConfig, tc: TrainConfig,
               phase: Callable[[str], None] | None = None):
    """One optimisation step, in place -> (state, metrics of 0-d tensors).
    batch: video [B, T, H, W, 3] normalised, gt [B, T, H, W] disparity,
    mask [B, T, H, W] (tensors or arrays). ``phase`` is called with
    "encoder", "head", "backward", "optimizer" and "end" as each begins;
    with it, the step's spans (``vda.train.step``, the root, and its
    stages) add to ``utils.profiling.totals()``."""
    sink = profiling.collecting() if phase else contextlib.nullcontext()
    with sink, profiling.span("vda.train.step"):
        lr = cosine_lr(tc, state.step)
        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, aux = loss_fn(state, batch, cfg, tc, phase)
            if phase:
                phase("backward")
            with profiling.span("vda.train.backward", device=loss.is_cuda):
                loss.backward()
        with profiling.span("vda.train.grad_fill"):
            for t in state.head.values():   # unreached by the forward: zero, decayed as optax does
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
            metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
        if state.mesh is not None:
            with profiling.span("vda.train.all_reduce"):
                _mean_over([t.grad for t in state.head.values()], state.mesh)
                if state.split is not None:   # the whole tensors: one update on every rank
                    _mean_over([t.grad for n, t in state.head.items() if n not in state.split],
                               state.mesh, "model")
                values = torch.stack(list(metrics.values()))
                _mean_over([values], state.mesh)
                metrics = dict(zip(metrics, values.unbind()))
        if phase:
            phase("optimizer")
        with profiling.span("vda.train.optimizer"):
            state.opt.step()
        if phase:
            phase("end")
        state.step += 1
    return state, metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: dict, cfg: ModelConfig, tc: TrainConfig) -> dict:
    loss, aux = loss_fn(state, batch, cfg, tc)
    return {"loss": loss, **aux}
