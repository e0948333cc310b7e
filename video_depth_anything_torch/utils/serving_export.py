"""The serving artifact: the window program exported by ``torch.export``.

The port of the JAX package's ``utils/serving_export.py``.
``WindowProgram`` is the exact program the pipeline's plain mode
(``pipeline/infer.py::PlainWindows``, which calls it) runs on a chunk of
windows: uint8 frames -> cv2-exact cubic resize and ImageNet
normalisation -> the model (ReLU at network resolution) -> bilinear
upsample to the source size -> ReLU. ``export_window_program`` freezes it
for one source geometry, dtype and window count C, with the JAX artifact's
calling convention: ``(state_dict, win_u8 [C, 32, H, W, 3] uint8) ->
depth [C, 32, H, W] float32``. The state dict is an argument, run through
``torch.func.functional_call``, so the saved file holds no weights, only
the constants the trace lifted (the resize matrices, the normalisation
constants, a RoPE table), and one artifact serves every checkpoint of its
encoder.

Every kernel the model calls is a ``torch.library`` custom op
(``kernels/__init__.py``), so the graph holds ``vda::`` nodes whatever
device it was traced on, and a call of the artifact on the card launches
the same kernels, as many times, as the live program. So there is no
``use_pallas`` option: the kernels are always in the artifact. ``device``
takes the place of JAX's ``platforms``: an artifact traced on the CPU
holds the same graph, and ``load_exported(path, device="cuda")`` moves its
constants and the devices named in its graph to the card
(``torch.export.passes.move_to_device_pass``). No branch outside the ops
tests the device while the model traces (the int8 product is
``torch._int_mm`` on either device, exact in int32), so the moved artifact
computes what one traced on the card does.

Layout: ``<path>`` holds ``torch.export.save``'s archive, ``<path>.json``
the metadata (format, the device traced on, bytes, input and output, the
``vda::`` ops in the graph and the caller's extras). ``load_exported``
imports the port's ``kernels`` package, which registers the ops, and
nothing of the model code.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

from .. import kernels  # noqa: F401  (registers the vda:: custom ops)
from ..config import INFER_LEN, ModelConfig
from ..ops.resize import apply_separable, device_matrix
from . import profiling

FORMAT = "vda-torch-window-program-v1"


class WindowProgram(nn.Module):
    """The window program: ``(state, win_u8 [C, 32, H, W, 3] uint8) ->
    depth [C, 32, H, W] float32`` at network size ``net_hw`` in ``dtype``.

    ``state`` None runs ``model`` with its own weights (the live call);
    a state dict runs it with those (the artifact's calling convention).
    The resize matrices and the ImageNet mean / std are built here, once,
    as buffers, outside any trace; ``model`` is held as a plain attribute,
    not a submodule, so an export of this module records its weights as
    inputs and saves none of them.
    """

    def __init__(self, model: nn.Module, net_hw, src_hw, dtype: torch.dtype):
        super().__init__()
        from ..pipeline.preprocess import preprocess_consts

        object.__setattr__(self, "model", model)
        self.net_hw, self.src_hw, self.dtype = tuple(net_hw), tuple(src_hw), dtype
        device = next(model.parameters()).device
        for name, t in zip(("in_h", "in_w", "mean", "std"),
                           preprocess_consts(self.src_hw, self.net_hw, device)):
            self.register_buffer(name, t)
        self.resize_out = self.net_hw != self.src_hw
        if self.resize_out:
            self.register_buffer("out_h", device_matrix(
                "linear", self.net_hw[0], self.src_hw[0], None, device, torch.float32))
            self.register_buffer("out_w", device_matrix(
                "linear", self.net_hw[1], self.src_hw[1], None, device, torch.float32))

    def forward(self, state: dict | None, win_u8: torch.Tensor) -> torch.Tensor:
        from ..pipeline.preprocess import preprocess_frames

        c = win_u8.shape[0]
        consts = (self.in_h, self.in_w, self.mean, self.std)
        x = preprocess_frames(win_u8.reshape(c * INFER_LEN, *win_u8.shape[2:]), self.net_hw,
                              self.dtype, consts)
        x = x.reshape(c, INFER_LEN, *x.shape[1:])
        if state is None:
            depth = self.model(x)                                   # [c, 32, h, w]
        else:
            depth = torch.func.functional_call(self.model, state, (x,))
        depth = depth.reshape(c * INFER_LEN, *depth.shape[2:], 1).float()
        with profiling.span("vda.pipeline.resize"):
            if self.resize_out:
                depth = apply_separable(depth, self.out_h, self.out_w)
            return torch.relu(depth)[..., 0].reshape(c, INFER_LEN, *self.src_hw)


def serving_dtype(fp32: bool) -> torch.dtype:
    return torch.float32 if fp32 else torch.bfloat16


def cast_params(state_dict: dict, fp32: bool = False) -> dict:
    """The state dict in the serving dtype: every floating tensor cast to
    bf16 unless ``fp32``, the rule of ``VideoDepthPipeline.model_in``
    (``Module.to(dtype)``)."""
    dtype = serving_dtype(fp32)
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in state_dict.items()}


def geometry(src_hw, input_size: int = 518) -> tuple[int, int]:
    """The network size for frames of ``src_hw``: the pipeline's rule."""
    from ..pipeline import preprocess

    eff = preprocess.effective_input_size(*src_hw, input_size)
    return preprocess.network_input_hw(*src_hw, eff)


def _structure(cfg: ModelConfig, device, quant: str | None, net_hw,
               dtype: torch.dtype) -> nn.Module:
    """The model whose structure the export traces, on ``device``, with
    PyTorch's default initialisation: its weights are replaced by the state
    argument. ``quant="int8"``: the int8 model quantized with absmaxes of 1,
    the calibration tree's shapes read from a forward on the meta device
    (no weights and no calibration window), after the cast to ``dtype``
    as the pipeline quantizes."""
    from ..models.video_depth import VideoDepthAnything
    from ..ops import quant as quant_ops

    with torch.device(device):
        model = VideoDepthAnything(cfg)
    model = model.eval().requires_grad_(False)
    if quant == "int8":
        with torch.device("meta"):
            meta = VideoDepthAnything(cfg)
        with torch.no_grad():
            stats = meta.calibrate_stats(torch.empty((1, 2, *net_hw, 3), device="meta"))
        model = quant_ops.quantize_model(model.to(dtype), _ones_like(stats))
    return model


def _ones_like(tree):
    if isinstance(tree, dict):
        return {k: _ones_like(v) for k, v in tree.items()}
    return np.ones(tree.shape, np.float32)


def build_window_fn(cfg: ModelConfig, net_hw, src_hw, dtype: torch.dtype, c: int = 1,
                    device="cuda", quant: str | None = None) -> WindowProgram:
    """The window program over a structure of ``cfg`` (``_structure``),
    called ``(state, win_u8)``. ``c`` is the JAX signature's window count:
    the program reads C from its input. Shared by the exporter and by
    verification oracles."""
    del c
    return WindowProgram(_structure(cfg, device, quant, net_hw, dtype), net_hw, src_hw, dtype)


def quantize_for_serving(model: nn.Module, calib_win_u8, cfg: ModelConfig, net_hw,
                         fp32: bool = False, calib_path: str | None = None) -> dict:
    """The int8 model's state dict an int8 artifact takes: the pipeline's
    own int8 model (``VideoDepthPipeline.quantized_model``) for
    ``calib_win_u8``'s first window ([C, 32, H, W, 3] or [32, H, W, 3]
    uint8, source resolution), on the model's device, calibrated as the
    pipeline calibrates on a video's first window; with ``calib_path`` its
    absmaxes come from (or go to) that side file, so an artifact and the
    pipeline share ``<ckpt>.int8calib.npz``."""
    from ..pipeline import VideoDepthPipeline

    win = np.asarray(calib_win_u8)
    pipe = VideoDepthPipeline(cfg, model, device=next(model.parameters()).device,
                              quant="int8", calib_path=calib_path)
    return dict(pipe.quantized_model(win.reshape(-1, *win.shape[-4:])[0], net_hw,
                                     serving_dtype(fp32)).state_dict())


def _is_split(model: nn.Module) -> bool:
    return any(getattr(m, "tp", None) is not None for m in model.modules())


def export_window_program(cfg: ModelConfig, src_hw, input_size: int = 518,
                          fp32: bool = False, windows_per_batch: int = 1,
                          device="cuda", quant: str | None = None,
                          model: nn.Module | None = None) -> torch.export.ExportedProgram:
    """Export the window program for fixed source geometry.

    The exported program takes ``(state_dict, win_u8 [C, 32, src_h, src_w,
    3] uint8)`` and returns ``depth [C, 32, src_h, src_w] float32``, the
    network size derived from (src_hw, input_size) by the pipeline's rule.
    ``state_dict`` is keyed by the port's state-dict names (a strict
    ``load_state_dict`` of a reference ``.pth`` gives the same keys) in the
    serving dtype: ``cast_params(model.state_dict(), fp32)``, or with
    ``quant="int8"`` ``quantize_for_serving``'s int8 state dict (int8
    weights, their scales and the absmaxes stay arguments, so one int8
    artifact serves every calibrated checkpoint).

    The trace runs under ``torch.no_grad()`` on ``device`` over
    ``_structure``'s model (PyTorch's default initialisation; int8: built
    on the meta device's calibration shapes, no calibration window), or
    over ``model`` when given (for ``quant="int8"`` the int8 model, whose
    state dict is taken as it is). A model split over a mesh's model axis raises
    ``ValueError``: the artifact is the one-device program, and the JAX
    export takes no mesh either.
    """
    if quant not in (None, "int8"):
        raise ValueError(f"quant={quant!r}; the export takes None or 'int8'")
    src_hw = (int(src_hw[0]), int(src_hw[1]))
    net_hw = geometry(src_hw, input_size)
    dtype = serving_dtype(fp32)
    c = int(windows_per_batch)
    if model is None:
        program = build_window_fn(cfg, net_hw, src_hw, dtype, c, device, quant)
        model = program.model
    elif _is_split(model):
        raise ValueError("the model is split over a mesh's model axis; export the whole "
                         "model (parallel.gather_model)")
    else:
        program = WindowProgram(model, net_hw, src_hw, dtype)
    dev = next(model.parameters()).device
    state = dict(model.state_dict()) if quant else cast_params(model.state_dict(), fp32)
    win = torch.zeros((c, INFER_LEN, *src_hw, 3), dtype=torch.uint8, device=dev)
    with torch.no_grad():
        ep = torch.export.export(program, (state, win), strict=False)
    ep.example_inputs = None   # they hold the structure's weights: not for the artifact
    # The resize matrices built inside the trace are lifted as host tensors
    # with an in-graph copy to the device: on the card, a pageable host-to-
    # device copy per call that waits for the card's queue. Moved, the
    # copies are no-ops.
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(ep, dev)


def op_counts(ep: torch.export.ExportedProgram) -> dict[str, int]:
    """The call nodes of an exported graph by target ("aten.to.dtype",
    "vda.spatial_attention.default", ...), the most frequent first."""
    counts: dict[str, int] = {}
    for node in ep.graph.nodes:
        if node.op == "call_function":
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def vda_op_counts(ep: torch.export.ExportedProgram) -> dict[str, int]:
    """The ``vda::`` custom-op nodes of an exported graph, by op name."""
    return {t.split(".")[1]: n for t, n in op_counts(ep).items() if t.startswith("vda.")}


def traced_device(ep: torch.export.ExportedProgram) -> torch.device:
    """The device the program was traced on (that of its input frames)."""
    win = [n for n in ep.graph.nodes if n.op == "placeholder"][-1]
    return win.meta["val"].device


def save_exported(ep: torch.export.ExportedProgram, path: str,
                  extra_meta: dict | None = None) -> str:
    """Write the artifact to ``path`` and its metadata to ``path``.json,
    each through a temporary file and ``os.replace``. Returns ``path``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.export.save(ep, f)
    os.replace(tmp, path)
    meta = {
        "format": FORMAT,
        "device": str(traced_device(ep)),
        "torch": torch.__version__,
        "bytes": os.path.getsize(path),
        "input": "state_dict (the port's keys, serving dtype), "
                 "win_u8 [C, 32, H, W, 3] uint8 (source resolution)",
        "output": "depth [C, 32, H, W] float32",
        "vda_ops": vda_op_counts(ep),
        **(extra_meta or {}),
    }
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, path + ".json")
    return path


def load_exported(path: str, device=None) -> torch.export.ExportedProgram:
    """Read an artifact; with ``device`` of another type than the one it was
    traced on, move it there (``move_to_device_pass``). Call it through
    ``artifact_module(ep)(state_dict, win_u8)``."""
    with open(path, "rb") as f:
        ep = torch.export.load(f)
    if device is not None and torch.device(device).type != traced_device(ep).type:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, torch.device(device))
    return ep


def artifact_module(ep: torch.export.ExportedProgram):
    """``ep.module()`` as a callable ``(state_dict, win_u8) -> depth``.

    The exported program flattens its inputs by position, so the state dict
    is first put in the export's key order (a checkpoint read from disk may
    hold its keys in another); missing or unexpected keys raise, as a
    strict ``load_state_dict`` does."""
    from torch.utils import _pytree

    module = ep.module()
    spec = ep.call_spec.in_spec
    (keyed, _), _ = _pytree.tree_unflatten(list(range(spec.num_leaves)), spec)
    keys = list(keyed)

    def call(state: dict, win_u8: torch.Tensor) -> torch.Tensor:
        if set(state) != set(keys):
            raise KeyError(f"state dict keys differ from the artifact's: missing "
                           f"{sorted(set(keys) - set(state))[:5]}, unexpected "
                           f"{sorted(set(state) - set(keys))[:5]}")
        return module({k: state[k] for k in keys}, win_u8)

    return call
