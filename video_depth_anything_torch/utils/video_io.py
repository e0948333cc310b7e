"""Host-side video decode and encode with OpenCV (the port's copy of the
cv2 backend of the JAX package's ``utils/video_io.py``).

fps-stride resampling, max_res downscale to even sizes, max_len
truncation, and an inferno or grayscale depth visualisation. The streaming
mode's pieces keep host memory bounded: ``stream_video_frames`` decodes on
a background thread into a bounded queue, ``IncrementalVideoWriter``
encodes frames as they arrive, ``DepthSpool`` spills depth chunks to a raw
file with the exact running range, and ``save_depth_video_streamed``
encodes the depth video from it block by block. cv2 (and matplotlib for
the inferno palette) are imported inside the functions: machines that only
run the model need neither.
"""
from __future__ import annotations

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


def read_video_frames(video_path: str, process_length: int = -1,
                      target_fps: float = -1, max_res: int = -1):
    """-> (frames [N, H, W, 3] uint8 RGB, fps)."""
    cap, fps, stride, scale_hw, _ = _open_video(video_path, target_fps, max_res)
    try:
        frames = list(_decoded(cap, stride, scale_hw, process_length))
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return np.stack(frames, axis=0), fps


def stream_video_frames(video_path: str, process_length: int = -1,
                        target_fps: float = -1, max_res: int = -1,
                        prefetch: int = 64):
    """Streaming decode: -> (frame iterator, fps, (h, w)).

    read_video_frames's fps stride, max_res and max_len, but a background
    thread decodes into a queue of at most ``prefetch`` frames, so decode
    overlaps the pipeline's compute and host memory stays O(prefetch).
    Closing the generator ends the thread and releases its capture before
    close() returns; dropping it, started or not, ends them too.
    """
    cap, fps, stride, scale_hw, out_hw = _open_video(video_path, target_fps, max_res)
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
            for frame in _decoded(cap, stride, scale_hw, process_length):
                if not put(frame):
                    break
        except Exception as e:   # surfaced on the consumer's side
            put(e)
        finally:
            cap.release()
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
    """An mp4 (OpenCV mp4v, as save_video) encoded frame by frame, so the
    frames never accumulate in host memory. A context manager, or call
    close()."""

    def __init__(self, output_path: str, fps: float):
        self.path = output_path
        self.fps = fps
        self._w = None

    def append(self, frame_rgb: np.ndarray) -> None:
        import cv2

        if self._w is None:
            h, w = frame_rgb.shape[:2]
            self._w = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*"mp4v"),
                                      self.fps, (w, h))
            if not self._w.isOpened():
                self._w = None
                raise IOError(f"cannot open video writer for {self.path}")
        self._w.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self._w is not None:
            self._w.release()
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_video(frames: np.ndarray, output_path: str, fps: float = 10,
               is_depths: bool = False, grayscale: bool = False) -> None:
    """Write an mp4 (OpenCV mp4v). frames: [N, H, W, 3] uint8 RGB, or
    [N, H, W] float depth when ``is_depths``."""
    if is_depths:
        frames = depth_visualization(np.asarray(frames), grayscale)
    with IncrementalVideoWriter(output_path, fps) as writer:
        for f in np.asarray(frames):
            writer.append(f)


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
