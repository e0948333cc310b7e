"""VideoDepthPipeline: sliding-window video depth on one device.

The port of the JAX package's ``pipeline/infer.py``.
``infer_video_depth(frames)`` returns ``(depths [N, H, W] float32, fps)``
through one of three forward modes, numerically interchangeable:

- sequential keyframe cache (``windows_per_batch=1``, the default): the
  encoder is strictly per-frame and each window's first OVERLAP inputs are
  the previous window's KEYFRAMES inputs, so their tap features are reused
  and only the 22 new frames are encoded; the temporal head sees all 32.
- batched keyframe cache (``windows_per_batch=C > 1``): every window row
  is a source frame index (``windows.py``), so a chunk of C windows needs
  each unique source frame encoded once. The frames not yet resident are
  encoded, each window's features are gathered (``index_select``) from
  concat(resident, new), the head runs on [C, 32], and the last window's
  10 keyframe features stay resident on the device for the next chunk.
- plain (``cache_keyframe_features=False``): the full 32-frame forward,
  C windows per chunk.

``infer_video_depth_streaming(frame_iter)`` runs the two cached modes on a
frame iterator in bounded host memory (C = 1: one window of frames; C > 1:
one chunk's new frames, the keyframe features staying on the device). Its
chunks concatenate to ``infer_video_depth``'s result with the same C, bit
for bit.

No shape buckets: the JAX package pads each encode batch to 22C + 10 or 22C
rows and the tail chunk to C windows, because jit compiles a program per
shape. Eager PyTorch needs neither, so the port encodes exactly a chunk's
new frames (no encode at all when every frame the chunk needs is
resident) and runs the tail chunk's head on its own r windows.

Transfers, on a card: each chunk's frames (and the batched cache's slot
indices) are staged in pinned host buffers, two per kind used in turn (a
buffer is refilled only after its last copy completed), and copied with
``non_blocking=True`` on a copy stream right after the previous chunk's
compute is enqueued; the compute stream waits on the copy's event. Each
chunk's finalised frames are copied into pinned host memory with
``non_blocking=True`` and read one chunk later, after their event.
``transfer_fp16=True`` casts only the emitted frames (and the last tail) to
fp16 on the device: the stitch carry stays fp32 and the results are fp32.
On the CPU, and with ``HostLink(overlap=False)`` (the reference the
overlapped path is tested against on a card), every copy is blocking.

Stitching is fp32 on the device, window by window (``stitch.py``). ReLU and
the resize to source resolution come in each JAX mode's order: the
sequential cache resizes, then applies ReLU; the plain and batched modes
apply ReLU at network resolution, then resize. They differ where the head
output is negative, and each mode is held to its JAX counterpart.

Every stage opens a span of ``utils/profiling.py`` (``vda.clip``, the
call's root; ``vda.pipeline.*``), named in a ``torch.profiler`` trace.
``collect_timings=True`` also adds them to the process's totals and keeps
``window_forward`` (each chunk's device interval, from CUDA events
resolved after the call's last fetch; host time on the CPU) and
``gather_upload`` (the next chunk's gather and upload inside it) in
``self.timer`` (``WindowTimer``). Nothing synchronises the card for it, so
a timed call overlaps copies and compute as an untimed one does.

``quant="int8"`` runs every mode with the int8 model of ``ops/quant.py``,
calibrated on the first window's frames (streaming buffers that whole
window before any compute, so both APIs calibrate on the same frames);
with ``calib_path`` the activation absmaxes persist in an ``.npz`` side
file stamped with the calibration geometry (the JAX package's format, so
either package reads the other's file) and are reused while the geometry
matches.

``mesh=`` (``parallel/mesh.py``, one device per rank) serves one video over
the ranks of a process group, in JAX's order of operations: every rank
holds the whole video and rank 0's weights, split over the mesh's model
axis when it is wider than 1 (each rank its heads and its part of the MLP
hidden); C is rounded up to a multiple of the data axis and the batched
cache is used even at C = 1 (never the sequential one). The ranks of one
model group take the same rows and return the same depths, bit for bit.
Each rank uploads only its rows of a chunk
(``DataAxis``): under the batched cache its share of the new frames to
encode, whose features are all-gathered so every rank holds the resident
table, then its share of the windows for the head; in plain mode its
share of the windows. The depths are all-gathered before stitching, so
every rank stitches the same windows and returns the full array. Rows are
padded with the last one to a multiple of the axis (``all_gather`` takes
equal sizes) and the padding is dropped after each gather. With int8
every rank calibrates on the same first window and only rank 0 writes the
side file; on a model axis the int8 model is gathered whole
(``parallel.gather_model``), quantized (the per-channel scales of a
row-split weight span its whole contraction axis) and then split, and the calibration's absmaxes of split activations are a
MAX over the model group. Streaming runs on a mesh of one rank only.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import os
import warnings
import zipfile
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import FRAME_STEP, INFER_LEN, KEYFRAMES, OVERLAP, ModelConfig
from ..ops import quant as quant_ops
from ..ops.resize import resize_bilinear_align_corners
from ..parallel.distributed import process_batch_bounds
from ..parallel.mesh import (data_size, gather_model, mesh_device, model_axis, shard_params,
                             split_params)
from ..utils import profiling
from ..utils.serving_export import WindowProgram
from ..utils.tree import flatten_tree, unflatten_tree
from . import preprocess, stitch, windows

# Reserved key prefix stamping the calibration geometry into the int8 side
# file (flatten_tree keys are model paths and never start with "__").
_CALIB_META = "__calib_meta__"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")   # "bfloat16", "float32"


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def _save_calib(path, stats, net_hw, dtype):
    """Persist calibration stats (a tree of NumPy arrays) atomically: a
    temp file, then os.replace."""
    # .npz suffix required: np.savez appends it to names without one.
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez_compressed(
            tmp,
            **{_CALIB_META + "/net_hw": np.asarray(net_hw, np.int64),
               _CALIB_META + "/dtype": np.asarray(_dtype_name(dtype))},
            **flatten_tree(stats))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_calib(path, net_hw, dtype):
    """The stats tree if the side file matches (net_hw, dtype), else None.

    A legacy (meta-less) or mismatched file returns None; so does a
    truncated or corrupt one, with a warning. The caller recalibrates and
    overwrites it.
    """
    try:
        with np.load(path) as data:
            files = set(data.files)
            meta_hw = data[_CALIB_META + "/net_hw"] if _CALIB_META + "/net_hw" in files else None
            meta_dt = data[_CALIB_META + "/dtype"] if _CALIB_META + "/dtype" in files else None
            if (meta_hw is None or tuple(meta_hw) != tuple(net_hw)
                    or meta_dt is None or str(meta_dt) != _dtype_name(dtype)):
                return None
            flat = {k: np.asarray(data[k]) for k in data.files
                    if not k.startswith(_CALIB_META)}
        return unflatten_tree(flat)
    except (zipfile.BadZipFile, OSError, KeyError, ValueError) as e:
        warnings.warn(f"unreadable int8 calibration file {path} ({e}); recalibrating")
        return None


def scale_side_file(src, dst, factor: float) -> None:
    """Copy an int8 side file with every absmax scaled by ``factor`` (the
    flip-floor run of ``utils/precision.py::flip_floor_report``)."""
    with np.load(src) as data:
        arrays = {k: data[k] if k.startswith(_CALIB_META)
                  else (data[k] * np.float32(factor)).astype(np.float32) for k in data.files}
    np.savez(dst, **arrays)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device



class Chunk(NamedTuple):
    """One device step: the source frames to upload ([H, W, 3] arrays,
    stacked in the upload's own buffer), its window count r, (batched
    cache) the slot indices rel [r * 32] then res_rel [10], and, once
    ``DataAxis.split`` has cut ``frames`` to a rank's share, the chunk's
    count of frames n before the cut."""
    frames: Sequence[np.ndarray]
    r: int
    index: np.ndarray | None = None
    n: int | None = None


class DataAxis:
    """A chunk split over a mesh's data axis, and the all_gather that
    reassembles it on every rank (JAX's ``_put_windows`` / ``_fetch``).

    ``take(rows, unit)`` is this rank's share of ``rows`` (a list, or a
    tensor whose first axis is taken), in groups of ``unit`` rows, padded
    with the last group to a multiple of the axis so that every rank gets
    as many (``process_batch_bounds``); ``gather(t, n)`` concatenates every
    rank's ``t`` on the first axis and drops the rows from ``n`` on (the
    padding), in ``t``'s order of strides: the resize leaves the depths in
    a permuted layout and the stitch sums in the order of the layout, so a
    mesh of one rank stays bit for bit with no mesh. Each collective is
    the span ``vda.pipeline.all_gather`` (device time on a card: the
    ``WindowTimer``'s ``all_gather``). The collectives are synchronous
    calls, so NCCL's stream is ordered after the kernels that produced
    ``t`` and before the ops that read the result."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.get_group("data")
        self.size = data_size(mesh)

    def take(self, rows, unit: int = 1):
        groups = len(rows) // unit
        if not groups:
            return rows
        pad = -groups % self.size
        lo, hi = process_batch_bounds(groups + pad, self.mesh)
        if pad and isinstance(rows, torch.Tensor):
            rows = torch.cat([rows, rows[-unit:].repeat(pad, *([1] * (rows.dim() - 1)))])
        elif pad:
            rows = list(rows) + list(rows[-unit:]) * pad
        return rows[lo * unit:hi * unit]

    def split(self, chunks: Iterator[Chunk], unit: int) -> Iterator[Chunk]:
        for chunk in chunks:
            yield chunk._replace(frames=self.take(chunk.frames, unit), n=len(chunk.frames))

    def gather(self, t: torch.Tensor, n: int) -> torch.Tensor:
        order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        with profiling.span("vda.pipeline.all_gather", device=t.is_cuda):
            dist.all_gather(parts, t, group=self.group)
        whole = torch.cat(parts)[:n]
        out = t.new_empty([whole.shape[d] for d in order])
        return out.permute(*[order.index(d) for d in range(t.dim())]).copy_(whole)


def slot_plan(sel: np.ndarray, res_ids: np.ndarray | None):
    """Host bookkeeping of one batched-cache chunk: windows ``sel`` [r, 32]
    of source frame ids, ``res_ids`` the 10 ids whose features are resident
    (None on the first chunk). -> (new_ids to encode, the index of
    ``Chunk``, the ids resident after the chunk). The feature table is
    concat(resident, new) on the frame axis; ``new_ids`` is empty when
    every frame is resident."""
    uniq = np.unique(sel)
    if res_ids is None:
        new_ids, slot, off = uniq, {}, 0
    else:
        new_ids = np.setdiff1d(uniq, res_ids)
        slot, off = {int(f): j for j, f in enumerate(res_ids)}, len(res_ids)
    slot.update({int(f): off + j for j, f in enumerate(new_ids)})
    last_kf = sel[-1][np.asarray(KEYFRAMES)]
    index = np.asarray([slot[int(f)] for f in sel.reshape(-1)]
                       + [slot[int(f)] for f in last_kf], np.int64)
    return new_ids, index, last_kf


class SequentialKeyframeCache:
    """Window by window: the frames uploaded are encoded, the previous
    window's KEYFRAMES features are reused; resize to source, then ReLU."""

    def __init__(self, model, ph: int, pw: int, net_hw, src_hw, dtype, device):
        self.model, self.ph, self.pw = model, ph, pw
        self.net_hw, self.src_hw, self.dtype = net_hw, src_hw, dtype
        self.kf = torch.tensor(KEYFRAMES, device=device)
        self.feats = None

    def __call__(self, frames: torch.Tensor, index, r: int, n=None) -> torch.Tensor:
        new = self.model.encode(preprocess.preprocess_frames(frames, self.net_hw, self.dtype))
        if self.feats is not None:
            kf = self.kf
            new = [(torch.cat([pt[kf], nt]), torch.cat([pc[kf], nc]))
                   for (pt, pc), (nt, nc) in zip(self.feats, new)]
        self.feats = new
        depth = self.model.head(new, self.ph, self.pw, 1, INFER_LEN)
        with profiling.span("vda.pipeline.resize"):
            depth = resize_bilinear_align_corners(depth.float(), self.src_hw)
            return torch.relu(depth)[..., 0][None]            # [1, 32, H, W]


class BatchedKeyframeCache:
    """A chunk of r windows: the new frames encoded once (none when all are
    resident), each window's features gathered from concat(resident, new),
    the head on [r, 32]; ReLU at network resolution, then the resize. The
    last window's KEYFRAMES features stay in ``resident``.

    With a ``DataAxis``: ``frames`` are this rank's share of the chunk's n
    new frames; their features are all-gathered (the padding dropped), so
    every rank holds the whole table and the same ``resident``; the head
    runs on this rank's share of the r windows, and the depths are
    all-gathered."""

    def __init__(self, model, ph: int, pw: int, net_hw, src_hw, dtype,
                 axis: DataAxis | None = None):
        self.model, self.ph, self.pw = model, ph, pw
        self.net_hw, self.src_hw, self.dtype = net_hw, src_hw, dtype
        self.axis = axis
        self.resident = None     # 4 taps x (patch [10, P, D], cls [10, D])

    def __call__(self, frames: torch.Tensor, index: torch.Tensor, r: int, n=None) -> torch.Tensor:
        rel, res_rel = index[: r * INFER_LEN], index[r * INFER_LEN:]
        table = self.resident
        if frames.shape[0]:   # K1's grid takes no empty batch
            new = self.model.encode(preprocess.preprocess_frames(frames, self.net_hw, self.dtype))
            if self.axis is not None:
                new = [(self.axis.gather(t, n), self.axis.gather(c, n)) for t, c in new]
            table = new if table is None else [
                (torch.cat([rt, nt]), torch.cat([rc, nc]))
                for (rt, rc), (nt, nc) in zip(table, new)]
        if self.axis is not None:
            rel = self.axis.take(rel.view(r, INFER_LEN)).reshape(-1)
        rows = rel.shape[0] // INFER_LEN
        feats = [(t.index_select(0, rel), c.index_select(0, rel)) for t, c in table]
        self.resident = [(t.index_select(0, res_rel), c.index_select(0, res_rel))
                         for t, c in table]
        depth = self.model.head(feats, self.ph, self.pw, rows, INFER_LEN)
        with profiling.span("vda.pipeline.resize"):
            depth = resize_bilinear_align_corners(torch.relu(depth.float()), self.src_hw)
            depth = depth[..., 0].reshape(rows, INFER_LEN, *self.src_hw)
        return depth if self.axis is None else self.axis.gather(depth, r)


class PlainWindows:
    """The full forward of r windows of 32 uploaded frames (ReLU at network
    resolution inside the model), then the resize to source: the window
    program the serving artifact exports (``utils/serving_export.py``),
    called with the model's own weights. With a ``DataAxis`` the frames
    are this rank's share of the windows, and the depths are
    all-gathered."""

    def __init__(self, model, net_hw, src_hw, dtype, axis: DataAxis | None = None):
        self.program = WindowProgram(model, net_hw, src_hw, dtype)
        self.axis = axis

    def __call__(self, frames: torch.Tensor, index, r: int, n=None) -> torch.Tensor:
        rows = frames.shape[0] // INFER_LEN
        depth = self.program(None, frames.reshape(rows, INFER_LEN, *frames.shape[1:]))
        return depth if self.axis is None else self.axis.gather(depth, r)


class HostLink:
    """Host <-> device copies of one pipeline call.

    With ``overlap`` on a card: an upload is staged in a pinned buffer (two
    per kind, used in turn; a buffer is refilled only once the event of its
    previous copy has completed), copied with ``non_blocking=True`` on a
    copy stream, and the compute stream waits on the copy's event; a
    download goes to a fresh pinned tensor with ``non_blocking=True`` on the
    compute stream and is read only after its event. Otherwise (the CPU, or
    ``overlap=False``) every copy is blocking.
    """

    def __init__(self, device: torch.device, overlap: bool = True):
        self.device = device
        self.overlap = overlap and device.type == "cuda"
        if self.overlap:
            self.compute = torch.cuda.current_stream(device)
            self.stream = torch.cuda.Stream(device)
            self.staging: dict[str, list] = {}

    def upload(self, rows: Sequence[np.ndarray], kind: str) -> torch.Tensor:
        """``rows`` stacked on a new first axis, on the device; an empty
        sequence gives an empty tensor."""
        with profiling.span("vda.pipeline.upload", mallocs=True):
            return self._upload(rows, kind)

    def _upload(self, rows, kind):
        if not len(rows):
            return torch.empty((0,), device=self.device)
        if not self.overlap:
            return torch.from_numpy(np.stack(rows)).to(self.device)
        shape = (len(rows), *np.shape(rows[0]))
        dtype = torch.from_numpy(np.empty(0, np.asarray(rows[0]).dtype)).dtype
        slots = self.staging.setdefault(kind, [[None, None], [None, None]])
        slots.append(slots.pop(0))              # the buffer of two uploads ago
        buf, done = slots[-1]
        if done is not None:
            with profiling.span("vda.pipeline.wait"):
                done.synchronize()              # its last copy has left the buffer
        nbytes = math.prod(shape) * dtype.itemsize
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        host = buf[:nbytes].view(dtype).view(shape)
        np.stack(rows, out=host.numpy())        # the gather is the one host copy
        with torch.cuda.stream(self.stream):
            dev = torch.empty(shape, dtype=dtype, device=self.device)
            dev.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.compute.wait_event(done)
        dev.record_stream(self.compute)         # freed only after the compute's uses
        slots[-1] = [buf, done]
        return dev

    def download(self, t: torch.Tensor):
        with profiling.span("vda.pipeline.download"):
            if not self.overlap:
                return t.cpu()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.compute)
            return host, done

    def fetch(self, pending) -> np.ndarray:
        with profiling.span("vda.pipeline.fetch"):
            if not self.overlap:
                return pending.numpy()
            host, done = pending
            with profiling.span("vda.pipeline.wait"):
                done.synchronize()
            return host.numpy()


@dataclasses.dataclass
class _Stream:
    """What a frame iterator has delivered so far."""
    n: int
    ended: bool


def _sequential_chunks(frames, idx) -> Iterator[Chunk]:
    for i, row in enumerate(idx):
        yield Chunk([frames[f] for f in (row if i == 0 else row[OVERLAP:])], 1)


def _plain_chunks(frames, idx, c) -> Iterator[Chunk]:
    for s in range(0, len(idx), c):
        sel = idx[s:s + c]
        yield Chunk([frames[f] for f in sel.reshape(-1)], len(sel))


def _batched_chunks(frames, idx, c) -> Iterator[Chunk]:
    res_ids = None
    for s in range(0, len(idx), c):
        sel = idx[s:s + c]
        new_ids, index, res_ids = slot_plan(sel, res_ids)
        yield Chunk([frames[f] for f in new_ids], len(sel), index)


def _stream_sequential(it, first, state: _Stream) -> Iterator[Chunk]:
    """C = 1 from an iterator: window 0 is ``first`` padded with its last
    frame; each later window takes the next FRAME_STEP frames, padded with
    the last frame at the end of the stream."""
    last = first[-1]
    yield Chunk(first + [last] * (INFER_LEN - len(first)), 1)
    del first
    k = 1
    while not (state.ended and k >= windows.num_windows(state.n)):
        new = []
        if not state.ended:
            for f in it:
                new.append(np.asarray(f))
                if len(new) == FRAME_STEP:
                    break
            state.n += len(new)
            state.ended = len(new) < FRAME_STEP
            last = new[-1] if new else last
        yield Chunk(new + [last] * (FRAME_STEP - len(new)), 1)
        k += 1


def _stream_batched(it, first, c: int, state: _Stream) -> Iterator[Chunk]:
    """C > 1 from an iterator: the windows' rows follow the unclamped
    recurrence of ``windows.py`` (clamped to the last frame once the stream
    ended); frames are read as far as a chunk needs and dropped once no
    later window can reference them (the largest encoded id is kept: rows
    clamped at the end of the stream come back to it)."""
    store = dict(enumerate(first))
    hi_read = len(first)
    del first
    kf_pos = np.asarray(KEYFRAMES)
    res_ids, prev_row, s = None, None, 0
    while True:
        raw_rows = []
        for k in range(s, s + c):
            row = (np.arange(INFER_LEN, dtype=np.int64) if k == 0 else np.concatenate(
                [prev_row[kf_pos], k * FRAME_STEP + np.arange(OVERLAP, INFER_LEN, dtype=np.int64)]))
            raw_rows.append(row)
            prev_row = row
        while not state.ended and hi_read <= raw_rows[-1].max():
            f = next(it, None)
            if f is None:
                state.ended = True
                break
            store[hi_read] = np.asarray(f)
            hi_read += 1
            state.n += 1
        k_total = windows.num_windows(state.n) if state.ended else None
        if state.ended:
            r = min(c, k_total - s)
            sel = np.minimum(np.stack(raw_rows[:r]), state.n - 1)
        else:
            r, sel = c, np.stack(raw_rows)
        new_ids, index, res_ids = slot_plan(sel, res_ids)
        frames = [store[int(i)] for i in new_ids]
        keep_from = int(new_ids.max()) if len(new_ids) else hi_read - 1
        if state.ended:
            keep_from = min(keep_from, state.n - 1)
        for fid in [f for f in store if f < keep_from]:
            del store[fid]
        yield Chunk(frames, r, index)
        s += c
        if k_total is not None and s >= k_total:
            return


class VideoDepthPipeline:
    def __init__(self, cfg: ModelConfig, model: torch.nn.Module, device=None,
                 quant: str | None = None, calib_path: str | None = None,
                 transfer_fp16: bool = False, mesh=None):
        """``mesh``: a ``DeviceMesh`` (``parallel/mesh.py``); the device is
        then this rank's (``parallel.mesh_device``) unless ``device`` names
        one, and ``model`` is overwritten in place with rank 0's weights
        and, on a model axis wider than 1, split in place to this rank's
        shard (``parallel.shard_params``)."""
        if quant not in (None, "int8"):
            raise ValueError(f"quant={quant!r}; the pipeline takes None or 'int8'")
        self.cfg = cfg
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.axis = None
        self.tp = model_axis(mesh)
        if mesh is not None:
            shard_params(self.model, mesh)
            self.axis = DataAxis(mesh)
        self.quant = quant
        self.calib_path = calib_path
        self.transfer_fp16 = transfer_fp16
        self.timer: profiling.WindowTimer | None = None   # set by collect_timings=True
        self._by_dtype = {torch.float32: self.model}
        self._int8: dict = {}
    def model_in(self, dtype: torch.dtype) -> torch.nn.Module:
        """The model with every parameter and buffer cast to ``dtype``
        (built once per dtype, as the JAX pipeline casts its params)."""
        if dtype not in self._by_dtype:
            self._by_dtype[dtype] = copy.deepcopy(self.model).to(dtype)
        return self._by_dtype[dtype]

    def _calib_stats(self, model, calib_win, net_hw, dtype):
        """Activation absmaxes for int8: from calib_path when it matches the
        geometry, else one calibration forward over the window's frames
        (then written to calib_path)."""
        if self.calib_path and os.path.exists(self.calib_path):
            stats = _load_calib(self.calib_path, net_hw, dtype)
            if stats is not None:
                return stats
            warnings.warn(f"{self.calib_path} was calibrated for a different "
                          f"input_size/dtype; recalibrating for net_hw={net_hw}")
        x = preprocess.preprocess_frames(self._upload(calib_win), net_hw, dtype)
        stats = _numpy_tree(model.calibrate_stats(x[None]))
        if self.calib_path and (self.mesh is None or dist.get_rank() == 0):
            _save_calib(self.calib_path, stats, net_hw, dtype)
        return stats

    def quantized_model(self, calib_win, net_hw, dtype: torch.dtype) -> torch.nn.Module:
        """The int8 model for (net_hw, dtype), calibrated on ``calib_win``
        (uint8 frames) or from the side file; built once and cached."""
        key = (tuple(net_hw), dtype)
        if key not in self._int8:
            model = self.model_in(dtype)
            stats = self._calib_stats(model, calib_win, net_hw, dtype)
            if self.tp is None:
                self._int8[key] = quant_ops.quantize_model(model, stats)
            else:   # gathered whole, quantized, split; the whole copies dropped
                whole = quant_ops.quantize_model(gather_model(model, self.mesh), stats)
                self._int8[key] = split_params(whole, self.tp)
        return self._int8[key]

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)


    def _model_for(self, calib_win, net_hw, dtype) -> torch.nn.Module:
        if self.quant == "int8":
            return self.quantized_model(calib_win, net_hw, dtype)
        return self.model_in(dtype)

    def _geometry(self, src_h: int, src_w: int, input_size: int, fp32: bool):
        eff = preprocess.effective_input_size(src_h, src_w, input_size)
        net_hw = preprocess.network_input_hw(src_h, src_w, eff)
        p = self.cfg.vit.patch_size
        return net_hw, (net_hw[0] // p, net_hw[1] // p), (torch.float32 if fp32 else torch.bfloat16)

    @torch.no_grad()
    def _run(self, chunks: Iterator[Chunk], forward):
        """Runs ``chunks`` through ``forward`` and stitches; yields each
        chunk's finalised frames, then the last window's tail, as host
        arrays (fp16 under transfer_fp16). Chunk i + 1 is gathered and
        uploaded right after chunk i's compute is enqueued; chunk i's frames
        are read after chunk i + 1's compute is enqueued. No span is open
        across a ``yield``."""
        link = HostLink(self.device)
        cuda = self.device.type == "cuda"
        out_dtype = torch.float16 if self.transfer_fp16 else torch.float32

        def upload(chunk):
            if chunk is None:
                return None
            index = None if chunk.index is None else link.upload([chunk.index], "index")[0]
            return link.upload(chunk.frames, "frames"), index, chunk.r, chunk.n

        nxt = upload(next(chunks, None))
        carry, pending = None, []
        while nxt is not None:
            frames, index, r, n = nxt
            with profiling.span("vda.pipeline.chunk", device=cuda, mallocs=True):
                depths = forward(frames, index, r, n)
                with profiling.span("vda.pipeline.gather_upload"):
                    nxt = upload(next(chunks, None))
            with profiling.span("vda.pipeline.stitch", mallocs=True):
                emits = []
                for d in depths:
                    if carry is None:
                        carry, emit = stitch.stitch_first(d)
                    else:
                        carry, emit = stitch.stitch_step(carry, d, metric=self.cfg.metric)
                    emits.append(emit)
                emitted = torch.cat(emits).to(out_dtype)
            pending.append(link.download(emitted))
            del emitted     # freed now: the next chunk's compute may reuse its block
            while len(pending) > 1:
                yield link.fetch(pending.pop(0))
        with profiling.span("vda.pipeline.stitch", mallocs=True):
            tail = carry[2].to(out_dtype)
        pending.append(link.download(tail))
        for p in pending:
            yield link.fetch(p)

    @torch.no_grad()
    def infer_video_depth(self, frames, target_fps: float = -1,
                          input_size: int = 518, fp32: bool = False,
                          windows_per_batch: int = 1,
                          collect_timings: bool = False,
                          cache_keyframe_features: bool = True):
        """frames: [N, H, W, 3] uint8 (or float in [0, 1]).

        Returns (depths [N, H, W] float32, target_fps). ``windows_per_batch``
        is capped at the number of windows; with collect_timings=True the
        spans' statistics land in ``self.timer.summary()`` and the spans
        in ``utils.profiling.totals()``.
        """
        self.timer = profiling.WindowTimer() if collect_timings else None
        sink = profiling.collecting(self.timer) if collect_timings else contextlib.nullcontext()
        with sink, profiling.span("vda.clip", mallocs=True) as clip:
            with profiling.span("vda.pipeline.setup"):
                frames = np.asarray(frames)
                n, src_h, src_w = frames.shape[:3]
                net_hw, (ph, pw), dtype = self._geometry(src_h, src_w, input_size, fp32)
                idx = windows.window_indices(n)
                model = self._model_for(frames[idx[0]], net_hw, dtype)
                c = max(1, min(windows_per_batch, len(idx)))
                src_hw = (src_h, src_w)
                axis = self.axis
                if axis is not None:    # the chunk tiles the data axis
                    c = -(-c // axis.size) * axis.size
                if cache_keyframe_features and c == 1 and axis is None:
                    forward = SequentialKeyframeCache(model, ph, pw, net_hw, src_hw, dtype,
                                                      self.device)
                    chunks = _sequential_chunks(frames, idx)
                elif cache_keyframe_features:
                    forward = BatchedKeyframeCache(model, ph, pw, net_hw, src_hw, dtype, axis)
                    chunks = _batched_chunks(frames, idx, c)
                else:
                    forward = PlainWindows(model, net_hw, src_hw, dtype, axis)
                    chunks = _plain_chunks(frames, idx, c)
                if axis is not None:
                    chunks = axis.split(chunks, 1 if cache_keyframe_features else INFER_LEN)
                out = np.empty((FRAME_STEP * len(idx) + OVERLAP, src_h, src_w), np.float32)
            clip.add(frames=n)
            at = 0
            for part in self._run(chunks, forward):
                with profiling.span("vda.pipeline.copy_out"):
                    out[at:at + len(part)] = part
                at += len(part)
            assert at == len(out), (at, out.shape)
        return out[:n], target_fps

    @torch.no_grad()
    def infer_video_depth_streaming(self, frame_iter, input_size: int = 518,
                                    fp32: bool = False, windows_per_batch: int = 1):
        """Bounded-memory long-video inference from a frame iterator.

        frame_iter yields [H, W, 3] uint8 frames
        (``utils/video_io.py::stream_video_frames``). Yields finalised depth
        chunks [n_i, H, W] float32 whose concatenation is bit-identical to
        ``infer_video_depth`` with the same ``windows_per_batch`` on the same
        frames. C = 1 holds one window of frames; C > 1 one chunk's new
        frames plus the last one read, the keyframe features staying on
        the device. On a mesh (of one rank: more raise, as in JAX) the
        chunked form runs at every C, as the batch API's mesh path does.
        """
        if self.mesh is not None and dist.get_world_size() > 1:
            raise NotImplementedError(
                "multi-host streaming would require feeding every process "
                "an identical frame stream; use infer_video_depth with "
                "windows_per_batch for multi-host serving")
        c = max(1, windows_per_batch)
        with profiling.span("vda.clip", mallocs=True) as clip:
            with profiling.span("vda.pipeline.setup"):
                it = iter(frame_iter)
                first = []
                for f in it:
                    first.append(np.asarray(f))
                    if len(first) == INFER_LEN:
                        break
                if not first:
                    return
                src_hw = first[0].shape[:2]
                net_hw, (ph, pw), dtype = self._geometry(*src_hw, input_size, fp32)
                state = _Stream(n=len(first), ended=len(first) < INFER_LEN)
                window0 = np.stack(first + [first[-1]] * (INFER_LEN - len(first)))
                model = self._model_for(window0, net_hw, dtype)
                del window0
                if c == 1 and self.axis is None:
                    forward = SequentialKeyframeCache(model, ph, pw, net_hw, src_hw, dtype,
                                                      self.device)
                    chunks = _stream_sequential(it, first, state)
                else:
                    forward = BatchedKeyframeCache(model, ph, pw, net_hw, src_hw, dtype,
                                                   self.axis)
                    chunks = _stream_batched(it, first, c, state)
                    if self.axis is not None:
                        chunks = self.axis.split(chunks, 1)
                del first
            emitted = 0
            for part in self._run(chunks, forward):
                # Until the stream ends nothing emitted lies past it; after, n is final.
                if state.ended:
                    part = part[: max(0, state.n - emitted)]
                emitted += len(part)
                if len(part):
                    with profiling.span("vda.pipeline.copy_out"):
                        part = np.array(part, dtype=np.float32)
                    yield part      # the root span stays open while the caller holds it
            clip.add(frames=emitted)
