"""The port's mp4 writers and ffmpeg reader against the JAX package's.

No imageio ffmpeg plugin and no imageio_ffmpeg are installed here, so both
are stubbed, and both packages run against the same stubs:

  - ``imageio.get_writer`` records its arguments and frames (libx264 at crf
    18, ``macro_block_size=1``, the frames in order); a stub that raises at
    the first ``append_data`` (a missing plugin or codec shows there) must
    send both packages to OpenCV mp4v, with the writer closed and the
    partial file gone before cv2 writes its own;
  - an ``imageio_ffmpeg`` module whose ``read_frames`` yields a meta dict,
    then raw RGB24 frames (applying the stride filter it is given, and
    rotating the geometry as ffmpeg's autorotation does), drives both
    readers: frames, fps and output size, the ``output_params`` filter, the
    90 / 270 rotation swap, the error on a short frame, ``process_length``
    and ``close()`` reaching the reader.
"""
import os
import sys
import types

import numpy as np
import pytest

from video_depth_anything_tpu.utils import video_io as jio
from video_depth_anything_torch.utils import video_io as tio

PACKAGES = {"jax": jio, "port": tio}


def frames(n=5, h=12, w=16, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, h, w, 3), np.uint8)


class StubWriter:
    def __init__(self, log, path, fail):
        self.log, self.path, self.fail = log, path, fail
        open(path, "wb").write(b"partial")   # ffmpeg has started on the file
        log["frames"] = []

    def append_data(self, f):
        if self.fail:
            raise RuntimeError("libx264 not available")
        self.log["frames"].append(np.array(f))

    def close(self):
        self.log["closed"] = self.log.get("closed", 0) + 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@pytest.fixture
def stub_writer(monkeypatch):
    import imageio

    log = {}

    def install(fail=False):
        log.clear()

        def get_writer(path, **kw):
            log["args"] = (path, kw)
            return StubWriter(log, path, fail)

        monkeypatch.setattr(imageio, "get_writer", get_writer)
        return log

    return install


X264 = dict(fps=7, macro_block_size=1, codec="libx264", ffmpeg_params=["-crf", "18"])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_writers_use_libx264_crf18(pkg, stub_writer, tmp_path):
    io = PACKAGES[pkg]
    f = frames()
    log = stub_writer()
    io.save_video(f, str(tmp_path / "a.mp4"), fps=7)
    assert log["args"] == (str(tmp_path / "a.mp4"), X264)
    np.testing.assert_array_equal(np.stack(log["frames"]), f)
    assert log["closed"] == 1
    log = stub_writer()
    with io.IncrementalVideoWriter(str(tmp_path / "b.mp4"), 7) as w:
        for x in f:
            w.append(x)
    assert log["args"] == (str(tmp_path / "b.mp4"), X264)
    np.testing.assert_array_equal(np.stack(log["frames"]), f)
    assert log["closed"] == 1


def _read_cv2(path):
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("pkg", PACKAGES)
def test_writers_fall_back_to_mp4v_at_the_first_frame(pkg, stub_writer, tmp_path):
    io = PACKAGES[pkg]
    f = frames(4)
    log = stub_writer(fail=True)
    path = str(tmp_path / "a.mp4")
    io.save_video(f, path, fps=7)
    assert log["closed"] == 1
    assert _read_cv2(path) == 4   # OpenCV's MPEG-4 part 2 (mp4v) file
    log = stub_writer(fail=True)
    path = str(tmp_path / "b.mp4")
    with io.IncrementalVideoWriter(path, 7) as w:
        for x in f:
            w.append(x)
    assert log["closed"] == 1
    assert _read_cv2(path) == 4   # OpenCV's MPEG-4 part 2 (mp4v) file


def test_port_removes_the_partial_file_before_cv2(stub_writer, tmp_path, monkeypatch):
    import cv2

    seen = []
    real = cv2.VideoWriter

    def spy(path, *a):
        seen.append(open(path, "rb").read() if os.path.exists(path) else None)
        return real(path, *a)

    monkeypatch.setattr(cv2, "VideoWriter", spy)
    for write in (lambda p: tio.save_video(frames(2), p, fps=5),
                  lambda p: tio.IncrementalVideoWriter(p, 5).append(frames(1)[0])):
        stub_writer(fail=True)
        write(str(tmp_path / f"{len(seen)}.mp4"))
    assert seen == [None, None]


# ------------------------------------------------------------------ ffmpeg reader


def stub_ffmpeg(video, fps=30.0, rotate=None, short_at=None):
    """An imageio_ffmpeg module serving ``video`` [N, H, W, 3] as the
    decoded (autorotated) stream; the container's size is (W, H), swapped
    for a 90 / 270 rotation."""
    log = {"calls": [], "closed": 0}
    n, h, w, _ = video.shape

    def read_frames(path, pix_fmt="rgb24", output_params=None, **kw):
        log["calls"].append({"path": path, "pix_fmt": pix_fmt, "output_params": output_params})
        stride = 1
        if output_params:
            vf = output_params[output_params.index("-vf") + 1]
            stride = int(vf.split("\\,")[1].rstrip("))"))
        meta = {"size": (h, w) if rotate in (90, 270) else (w, h), "fps": fps}
        if rotate is not None:
            meta["rotate"] = rotate
        try:
            yield meta
            for i in range(0, n, stride):
                raw = video[i].tobytes()
                yield raw[:-3] if short_at == i else raw
        finally:
            log["closed"] += 1

    return types.SimpleNamespace(read_frames=read_frames), log


@pytest.fixture
def ffmpeg(monkeypatch):
    def install(*a, **kw):
        mod, log = stub_ffmpeg(*a, **kw)
        monkeypatch.setitem(sys.modules, "imageio_ffmpeg", mod)
        return log

    return install


def _both(fn):
    out = {}
    for name, io in PACKAGES.items():
        out[name] = fn(io)
    return out["jax"], out["port"]


@pytest.mark.parametrize("case", [
    dict(target_fps=-1, max_res=-1, process_length=-1),
    dict(target_fps=10, max_res=-1, process_length=-1),     # stride 3
    dict(target_fps=15, max_res=10, process_length=-1),     # stride 2, resized
    dict(target_fps=-1, max_res=-1, process_length=4),
])
@pytest.mark.parametrize("rotate", [None, 90, 270, 180])
def test_ffmpeg_readers_agree(ffmpeg, case, rotate):
    video = frames(9, 12, 16, seed=1)
    logs = {}

    def run(io):
        log = logs[io.__name__] = ffmpeg(video, rotate=rotate)
        got, fps = io.read_video_frames("v.mp4", decode_backend="ffmpeg", **case)
        it, sfps, hw = io.stream_video_frames("v.mp4", decode_backend="ffmpeg", prefetch=2, **case)
        streamed = np.stack(list(it))
        return got, fps, streamed, sfps, hw, log

    (jf, jfps, js, jsfps, jhw, jlog), (tf, tfps, ts, tsfps, thw, tlog) = _both(run)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ts, tf)
    assert (tfps, tsfps, thw) == (jfps, jsfps, jhw)
    stride = {-1: 1, 10: 3, 15: 2}[case["target_fps"]]
    n = len(range(0, 9, stride)) if case["process_length"] < 0 else case["process_length"]
    assert tf.shape[0] == n and thw == tf.shape[1:3]
    want = ["-vf", f"select=not(mod(n\\,{stride}))", "-vsync", "0"] if stride > 1 else []
    assert [c["output_params"] for c in tlog["calls"]] == [c["output_params"]
                                                            for c in jlog["calls"]]
    assert tlog["calls"][-1]["output_params"] == want
    assert tlog["closed"] == jlog["closed"] == len(tlog["calls"])   # every reader closed


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ffmpeg_short_frame_raises(ffmpeg, pkg):
    log = ffmpeg(frames(5, 12, 16), short_at=2)
    with pytest.raises(ValueError, match="ffmpeg pipe frame is"):
        PACKAGES[pkg].read_video_frames("v.mp4", decode_backend="ffmpeg")
    assert log["closed"] == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ffmpeg_early_close_reaches_the_reader(ffmpeg, pkg):
    log = ffmpeg(frames(20, 12, 16))
    it, _, _ = PACKAGES[pkg].stream_video_frames("v.mp4", decode_backend="ffmpeg", prefetch=2)
    next(it)
    it.close()
    import time

    deadline = time.time() + 10
    while log["closed"] < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert log["closed"] == 2


def test_port_ffmpeg_reads_without_cv2_when_not_resizing(ffmpeg, monkeypatch):
    """cv2 is needed only for the max_res resize."""
    video = frames(3, 12, 16)
    ffmpeg(video)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got, _ = tio.read_video_frames("v.mp4", decode_backend="ffmpeg")
    np.testing.assert_array_equal(got, video)
