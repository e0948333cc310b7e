"""Host-side video decode and encode (the port's copy of the JAX package's
``utils/video_io.py``).

Decode backends: OpenCV (default; its yuv->rgb rounding defines the
golden outputs) and an ffmpeg raw-pipe subprocess (``decode_backend=
"ffmpeg"`` or ``VDA_DECODE_BACKEND=ffmpeg``, through ``imageio_ffmpeg``).
Asking for ffmpeg without ``imageio_ffmpeg`` raises; nothing decodes with
cv2 in its place.

fps-stride resampling, max_res downscale to even sizes, max_len
truncation, and an inferno or grayscale depth visualisation. The streaming
mode's pieces keep host memory bounded: ``stream_video_frames`` decodes on
a background thread into a bounded queue, ``IncrementalVideoWriter``
encodes frames as they arrive, ``DepthSpool`` spills depth chunks to a raw
file with the exact running range, and ``save_depth_video_streamed``
encodes the depth video from it block by block.

Encode: libx264 at crf 18 through ``imageio.get_writer`` (the reference's
setting), falling back to OpenCV ``mp4v`` only where the JAX package does:
when the imageio ffmpeg plugin or the codec is missing, which shows at the
first ``append_data``; the partial file is removed and the writer's
subprocess closed first. cv2, imageio (and matplotlib for the inferno
palette) are imported inside the functions: machines that only run the
model need none of them.
"""
from __future__ import annotations

import contextlib
import os
import queue
import threading
import weakref

import numpy as np


def _ensure_even(v: int) -> int:
    return v if v % 2 == 0 else v + 1


def _open_video(video_path: str, target_fps: float, max_res: int):
    """-> (cap, fps, stride, scale_hw, out_hw): the capture, the output fps,
    the frame stride and the max_res size (None: unscaled)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    original_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    scale_hw = None
    if max_res > 0 and max(h, w) > max_res:
        scale = max_res / max(h, w)
        scale_hw = (_ensure_even(round(h * scale)), _ensure_even(round(w * scale)))
    fps = original_fps if target_fps <= 0 else target_fps
    stride = max(round(original_fps / fps), 1)
    return cap, fps, stride, scale_hw, (scale_hw or (h, w))


def _decoded(cap, stride: int, scale_hw, process_length: int):
    """The kept frames of an open capture, RGB, resized to scale_hw."""
    import cv2

    count = emitted = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            return
        if count % stride == 0:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if scale_hw is not None:
                frame = cv2.resize(frame, (scale_hw[1], scale_hw[0]),
                                   interpolation=cv2.INTER_AREA)
            yield frame
            emitted += 1
            if 0 < process_length <= emitted:
                return
        count += 1


def resolve_backend(decode_backend: str | None = None) -> str:
    """The decode backend: the argument, else ``VDA_DECODE_BACKEND``, else
    cv2. An unknown name raises, and so does ffmpeg without
    ``imageio_ffmpeg`` (the JAX package warns and decodes with cv2 when the
    request came from the environment; the port never swaps backends)."""
    backend = decode_backend or os.environ.get("VDA_DECODE_BACKEND") or "cv2"
    if backend not in ("cv2", "ffmpeg"):
        raise ValueError(f"unknown decode backend {backend!r} (expected 'cv2' or 'ffmpeg')")
    if backend == "ffmpeg":
        try:
            import imageio_ffmpeg  # noqa: F401
        except ImportError:
            raise ImportError("the ffmpeg decode backend needs the imageio_ffmpeg package, "
                              "which is not installed; use the cv2 backend") from None
    return backend


def _ffmpeg_frames(video_path: str, target_fps: float, max_res: int, process_length: int):
    """ffmpeg decodes, drops frames to the fps stride and converts to RGB24
    in a subprocess; frames come over a pipe -> (generator, fps, out_hw).
    The same round(original / target) stride and the same cv2 INTER_AREA
    max_res resize as the cv2 backend (cv2 is needed only for that
    resize). The JAX package's ``_ffmpeg_decode_iter``."""
    import imageio_ffmpeg

    probe = imageio_ffmpeg.read_frames(video_path, pix_fmt="rgb24")
    meta = next(probe)
    probe.close()
    w, h = meta["size"]
    if int(float(meta.get("rotate") or 0)) % 360 in (90, 270):   # ffmpeg autorotates
        w, h = h, w
    original_fps = meta.get("fps") or 30.0
    scale_hw = None
    if max_res > 0 and max(h, w) > max_res:
        scale = max_res / max(h, w)
        scale_hw = (_ensure_even(round(h * scale)), _ensure_even(round(w * scale)))
    fps = original_fps if target_fps <= 0 else target_fps
    stride = max(round(original_fps / fps), 1)
    out_params = ["-vf", f"select=not(mod(n\\,{stride}))", "-vsync", "0"] if stride > 1 else []
    reader = imageio_ffmpeg.read_frames(video_path, pix_fmt="rgb24", output_params=out_params)
    next(reader)   # meta

    def frames():
        try:
            emitted = 0
            for raw in reader:
                if len(raw) != h * w * 3:
                    raise ValueError(f"ffmpeg pipe frame is {len(raw)} bytes, expected "
                                     f"{h}x{w}x3 (probe size {meta['size']})")
                f = np.frombuffer(raw, np.uint8).reshape(h, w, 3)
                if scale_hw is not None:
                    import cv2
                    f = cv2.resize(f, (scale_hw[1], scale_hw[0]), interpolation=cv2.INTER_AREA)
                yield f
                emitted += 1
                if 0 < process_length <= emitted:
                    return
        finally:
            reader.close()

    gen = frames()
    weakref.finalize(gen, reader.close)   # a generator closed unstarted skips its finally
    return gen, fps, (scale_hw or (h, w))


def _open_frames(video_path: str, process_length: int, target_fps: float, max_res: int,
                 decode_backend: str | None):
    """-> (frame generator, fps, (h, w)) from the resolved backend; closing
    the generator releases its decoder."""
    if resolve_backend(decode_backend) == "ffmpeg":
        return _ffmpeg_frames(video_path, target_fps, max_res, process_length)
    cap, fps, stride, scale_hw, out_hw = _open_video(video_path, target_fps, max_res)

    def frames():
        try:
            yield from _decoded(cap, stride, scale_hw, process_length)
        finally:
            cap.release()

    gen = frames()
    weakref.finalize(gen, cap.release)   # a generator closed unstarted skips its finally
    return gen, fps, out_hw


def read_video_frames(video_path: str, process_length: int = -1,
                      target_fps: float = -1, max_res: int = -1,
                      decode_backend: str | None = None):
    """-> (frames [N, H, W, 3] uint8 RGB, fps)."""
    it, fps, _ = _open_frames(video_path, process_length, target_fps, max_res, decode_backend)
    with contextlib.closing(it):
        frames = list(it)
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return np.stack(frames, axis=0), fps


def stream_video_frames(video_path: str, process_length: int = -1,
                        target_fps: float = -1, max_res: int = -1,
                        prefetch: int = 64, decode_backend: str | None = None):
    """Streaming decode: -> (frame iterator, fps, (h, w)).

    read_video_frames's fps stride, max_res, max_len and backend, but a
    background thread decodes into a queue of at most ``prefetch`` frames,
    so decode overlaps the pipeline's compute and host memory stays
    O(prefetch). Closing the generator ends the thread and releases its
    decoder before close() returns; dropping it, started or not, ends them
    too.
    """
    source, fps, out_hw = _open_frames(video_path, process_length, target_fps, max_res,
                                       decode_backend)
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = object()
    abandoned = threading.Event()   # the consumer is gone: unblock put, release cap

    def put(item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for frame in source:
                if not put(frame):
                    break
        except Exception as e:   # surfaced on the consumer's side
            put(e)
        finally:
            source.close()
            put(stop)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()

    def frames():
        try:
            while True:
                item = q.get()
                if item is stop:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            abandoned.set()
            thread.join(timeout=10.0)   # the capture is released when close() returns

    gen = frames()
    # A generator closed before it started skips its finally; the finalizer
    # on the generator object still releases the decoder.
    weakref.finalize(gen, abandoned.set)
    return gen, fps, out_hw


def depth_visualization(depths: np.ndarray, grayscale: bool = False,
                        value_range=None) -> np.ndarray:
    """Globally min-max normalised depth video -> uint8 RGB. ``value_range``:
    (min, max) computed elsewhere (DepthSpool's exact running range), the
    same per element as letting this function scan ``depths``."""
    if value_range is not None:
        d_min, d_max = float(value_range[0]), float(value_range[1])
    else:
        d_min, d_max = float(depths.min()), float(depths.max())
    norm = ((depths - d_min) / ((d_max - d_min) or 1.0) * 255).astype(np.uint8)
    if grayscale:
        return np.repeat(norm[..., None], 3, axis=-1)
    import matplotlib
    lut = (np.asarray(matplotlib.colormaps["inferno"].colors) * 255).astype(np.uint8)
    return lut[norm]


class IncrementalVideoWriter:
    """An mp4 encoded frame by frame, so the frames never accumulate in host
    memory: libx264 crf 18, or OpenCV mp4v when the first frame shows the
    plugin or the codec missing. A context manager, or call close()."""

    def __init__(self, output_path: str, fps: float):
        self.path = output_path
        self.fps = fps
        self._w = None
        self._kind = None

    def _open(self, first_frame: np.ndarray) -> None:
        # imageio starts ffmpeg at the first append_data, so a missing
        # plugin or codec shows there: the failed writer is closed (ending
        # its subprocess) and its partial file removed before cv2 writes.
        w = None
        try:
            import imageio

            w = imageio.get_writer(self.path, fps=self.fps, macro_block_size=1,
                                   codec="libx264", ffmpeg_params=["-crf", "18"])
            w.append_data(first_frame)
            self._w, self._kind = w, "imageio"
            return
        except Exception:
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass
            try:
                os.remove(self.path)
            except OSError:
                pass
        import cv2

        h, w = first_frame.shape[:2]
        self._w = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        if not self._w.isOpened():
            raise IOError(f"cannot open video writer for {self.path}")
        self._kind = "cv2"
        self._write_cv2(first_frame)

    def _write_cv2(self, frame_rgb: np.ndarray) -> None:
        import cv2

        self._w.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))

    def append(self, frame_rgb: np.ndarray) -> None:
        if self._w is None:
            self._open(frame_rgb)
        elif self._kind == "imageio":
            self._w.append_data(frame_rgb)
        else:
            self._write_cv2(frame_rgb)

    def close(self) -> None:
        if self._w is not None:
            if self._kind == "imageio":
                self._w.close()
            else:
                self._w.release()
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_video(frames: np.ndarray, output_path: str, fps: float = 10,
               is_depths: bool = False, grayscale: bool = False) -> None:
    """Write an mp4: libx264 crf 18, else OpenCV mp4v (module docstring).
    frames: [N, H, W, 3] uint8 RGB, or [N, H, W] float depth when
    ``is_depths``."""
    if is_depths:
        frames = depth_visualization(np.asarray(frames), grayscale)
    with IncrementalVideoWriter(output_path, fps) as w:
        for f in np.asarray(frames):
            w.append(f)


class DepthSpool:
    """A file-backed spill buffer for streamed depth chunks.

    The vis and npz writers need the global min / max, so a streaming
    caller would otherwise hold every depth frame until the end. Each chunk
    is appended to a raw float32 file (O(chunk) resident) while the exact
    running min / max accumulate; finish() maps the file back read-only as
    an [N, H, W] memmap. The elements and the range are those of the
    concatenated chunks.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self.count = 0
        self.hw = None
        self.min = np.inf
        self.max = -np.inf

    def append(self, chunk: np.ndarray) -> None:
        chunk = np.ascontiguousarray(chunk, dtype=np.float32)
        if chunk.ndim != 3 or (self.hw is not None and chunk.shape[1:] != self.hw):
            raise ValueError(f"chunk {chunk.shape} does not continue [N, {self.hw}]")
        self.hw = chunk.shape[1:]
        if chunk.size:
            self.min = min(self.min, float(chunk.min()))
            self.max = max(self.max, float(chunk.max()))
        chunk.tofile(self._f)
        self.count += chunk.shape[0]

    def finish(self) -> np.ndarray:
        """Close the write side; -> the read-only [N, H, W] memmap."""
        self._f.close()
        if self.count == 0:
            return np.zeros((0, 0, 0), np.float32)
        return np.memmap(self.path, dtype=np.float32, mode="r",
                         shape=(self.count, *self.hw))

    def cleanup(self) -> None:
        """Remove the spill file (after every reader is done); idempotent."""
        if not self._f.closed:
            self._f.close()
        try:
            os.remove(self.path)
        except OSError:
            pass


def save_depth_video_streamed(depths, output_path: str, fps: float,
                              value_range, grayscale: bool = False,
                              chunk_frames: int = 64) -> None:
    """save_video(is_depths=True) for a memmap or large array, in blocks of
    ``chunk_frames`` frames; with DepthSpool's exact range the frames
    encoded are save_video's."""
    with IncrementalVideoWriter(output_path, fps) as w:
        for i in range(0, len(depths), chunk_frames):
            block = np.asarray(depths[i:i + chunk_frames])
            for f in depth_visualization(block, grayscale, value_range=value_range):
                w.append(f)
