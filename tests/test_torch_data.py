"""The port's training data (data/) against the JAX package's, bit for bit.

Both read the same synthetic trees (tests/test_data.py's VKITTI layout,
and a Google Landmarks image / .npy disparity pair of directories) with the
same seeds; every item, key for key, must be equal, and the loaders must
give the same batches in the same order.
"""
import numpy as np
import pytest

from video_depth_anything_tpu import data as jdata
from video_depth_anything_torch import data as tdata

from test_data import _make_vkitti


@pytest.fixture(scope="module")
def vkitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vkitti"))
    _make_vkitti(root, frames=6, hw=(40, 60))
    return root


@pytest.fixture(scope="module")
def landmarks_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("landmarks")
    rng = np.random.default_rng(3)
    for i, ext in enumerate(("jpg", "png", "jpg")):
        sub = root / "images" / f"g{i % 2}"
        dsub = root / "depth" / f"g{i % 2}"
        sub.mkdir(parents=True, exist_ok=True)
        dsub.mkdir(parents=True, exist_ok=True)
        hw = (36 + 4 * i, 50 - 2 * i)
        Image.fromarray(rng.integers(0, 255, (*hw, 3), np.uint8)).save(sub / f"im{i}.{ext}")
        disp = rng.uniform(0.0, 0.2, hw).astype(np.float32)
        disp[0, :3] = 2000.0   # beyond max_disp: masked
        np.save(dsub / f"im{i}.npy", disp)
    return str(root / "images"), str(root / "depth")


def assert_items_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("quantize", [True, False])
def test_vkitti_items_equal(vkitti_root, split, quantize):
    kw = dict(clip_len=4, resize_size=28, split=split, quantize_disparity=quantize, seed=5)
    j, t = jdata.VKITTIVideoDataset(vkitti_root, **kw), tdata.VKITTIVideoDataset(vkitti_root, **kw)
    assert len(j) == len(t) and j.video_infos == t.video_infos
    for _ in range(3):   # the clip start and crop follow each dataset's own RNG stream
        for i in range(len(j)):
            assert_items_equal(j[i], t[i])


def test_vkitti_errors_match(vkitti_root, tmp_path):
    for cls in (jdata.VKITTIVideoDataset, tdata.VKITTIVideoDataset):
        with pytest.raises(FileNotFoundError):
            cls(str(tmp_path), clip_len=4)
        with pytest.raises(ValueError, match="clip_len"):
            cls(vkitti_root, clip_len=9, resize_size=28)[0]


def test_landmarks_and_combined_items_equal(vkitti_root, landmarks_root):
    img, dep = landmarks_root
    j = jdata.GoogleLandmarksDataset(img, dep, resize_size=28, seed=2)
    t = tdata.GoogleLandmarksDataset(img, dep, resize_size=28, seed=2)
    assert len(j) == len(t) == 3 and j.image_paths == t.image_paths
    for i in range(3):
        assert_items_equal(j[i], t[i])
    for split in ("train", "val"):
        jv = jdata.VKITTIVideoDataset(vkitti_root, clip_len=4, resize_size=28, split=split)
        tv = tdata.VKITTIVideoDataset(vkitti_root, clip_len=4, resize_size=28, split=split)
        jc, tc = jdata.CombinedDataset(jv, img, dep), tdata.CombinedDataset(tv, img, dep)
        assert len(jc) == len(tc)
        for i in range(len(jc)):
            a, b = jc[i], tc[i]
            assert_items_equal(a, b)
            assert ("image_video" in b) == (split == "train")


def test_landmarks_missing_depth_raises(landmarks_root, tmp_path):
    img, _ = landmarks_root
    with pytest.raises(FileNotFoundError, match="depth file not found"):
        tdata.GoogleLandmarksDataset(img, str(tmp_path))


class _Toy:
    """Items that name their index, to read the loader's order."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.int64), "y": np.float32(i) * np.ones(3, np.float32)}


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, shuffle=True, seed=7),
    dict(batch_size=3, shuffle=True, seed=7, drop_last=False),
    dict(batch_size=2, shuffle=False),
    dict(batch_size=2, shuffle=True, seed=1, num_shards=3, shard_id=2),
    dict(batch_size=4, shuffle=True, seed=1, num_shards=2, shard_id=0, drop_last=False),
])
def test_loader_batches_equal(kw):
    j, t = jdata.DataLoader(_Toy(11), **kw), tdata.DataLoader(_Toy(11), **kw)
    assert len(j) == len(t)
    for _ in range(2):   # two epochs: the shuffle RNG advances alike
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb) == len(t)
        for a, b in zip(jb, tb):
            assert_items_equal(a, b)


def test_loader_shards_cover_the_epoch():
    seen = []
    for shard in range(3):
        loader = tdata.DataLoader(_Toy(10), batch_size=1, seed=4, num_shards=3, shard_id=shard)
        seen += [int(b["x"][0, 0]) for b in loader]
    assert len(seen) == len(set(seen)) == 9


def test_loader_surfaces_worker_errors():
    class Bad(_Toy):
        def __getitem__(self, i):
            raise RuntimeError("broken item")

    with pytest.raises(RuntimeError, match="broken item"):
        list(tdata.DataLoader(Bad(4), batch_size=2))
