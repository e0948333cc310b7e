"""The port's benchmark harness (benchmark/), validation metrics and
validation pictures against the JAX package's, on the CPU.

NumPy functions are held bit for bit: metrics, TAE, the evaluation
protocol, manifests (the same JSON), the extractors (the same files, byte
for byte, on the raw-layout trees of tests/test_benchmark_extractors.py),
``metric_val`` and the validation PNGs. ``infer_manifest`` runs each
package's own pipeline on the same weights: the .npy depths within the
pipeline's fp32 tolerance (rtol 1e-3, atol 1e-4 * max(range, 1),
tests/test_torch_pipeline.py), and the evaluation of those depths within
1e-3 relative.
"""
import json
import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from video_depth_anything_tpu.benchmark import evaluate as jevaluate
from video_depth_anything_tpu.benchmark import extract as jextract
from video_depth_anything_tpu.benchmark import infer as jinfer
from video_depth_anything_tpu.benchmark import manifests as jmanifests
from video_depth_anything_tpu.benchmark import metrics as jmetrics
from video_depth_anything_tpu.benchmark import tae as jtae
from video_depth_anything_tpu.config import ModelConfig as JModelConfig
from video_depth_anything_tpu.config import ViTConfig as JViTConfig
from video_depth_anything_tpu.models.video_depth import init_params
from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JPipeline
from video_depth_anything_tpu.training import validate as jvalidate
from video_depth_anything_tpu.training import visualize as jvisualize
from video_depth_anything_torch.benchmark import evaluate, extract, infer, manifests, metrics, tae
from video_depth_anything_torch.config import ModelConfig, ViTConfig
from video_depth_anything_torch.convert import model_from_params
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.training import validate, visualize

from test_benchmark_extractors import RAW_H, RAW_W, _dpt_bytes, _write_depth16, _write_rgb

torch.set_num_threads(2)


def depth_batch(seed=0, t=5, h=24, w=32):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 20.0, (t, h, w))
    pred = gt * rng.uniform(0.8, 1.25, (t, h, w))
    mask = rng.random((t, h, w)) > 0.3
    return pred, gt, mask


@pytest.mark.parametrize("name", [n for n in dir(jmetrics) if callable(getattr(jmetrics, n))
                                  and not n.startswith("_") and n not in ("threshold_percentage",)])
def test_metrics_bit_for_bit(name):
    pred, gt, mask = depth_batch()
    for m in (mask, None):
        a = getattr(jmetrics, name)(pred, gt, m)
        b = getattr(metrics, name)(pred, gt, m)
        np.testing.assert_array_equal(b, a)
    assert sorted(metrics.EVAL_METRICS) == sorted(jmetrics.EVAL_METRICS)


def test_tae_bit_for_bit():
    rng = np.random.default_rng(1)
    t, h, w = 4, 20, 28
    gt = rng.uniform(2.0, 9.0, (t, h, w))
    disp = (1.0 / gt) * 2.0 + 0.01 + 1e-3 * rng.standard_normal((t, h, w))
    ks = [np.array([[25.0, 0, w / 2], [0, 25.0, h / 2], [0, 0, 1]])] * t
    poses = []
    for i in range(t):
        p = np.eye(4)
        p[:3, 3] = [0.05 * i, 0.0, 0.02 * i]
        poses.append(p)
    masks = [rng.random((h, w)) > 0.2 for _ in range(t)]
    for m in (None, masks):
        a = jtae.eval_tae_sequence(disp, gt, ks, poses, 10.0, masks=m)
        b = tae.eval_tae_sequence(disp, gt, ks, poses, 10.0, masks=m)
        assert a == b
    args = (gt[0], gt[1], np.eye(3), np.array([0.1, 0.0, 0.0]), ks[0], masks[1])
    assert jtae.tae_pair(*args) == tae.tae_pair(*args)


def test_metric_val_bit_for_bit():
    rng = np.random.default_rng(2)
    t, h, w = 4, 24, 32
    gt = rng.uniform(2.0, 90.0, (t, h, w)).astype(np.float32)
    pred = ((1.0 / gt) * 3.0 + 0.02 + 1e-3 * rng.standard_normal((t, h, w))).astype(np.float32)
    poses = np.stack([np.eye(4)] * t)
    poses[:, 0, 3] = np.arange(t) * 0.1
    ks = np.stack([np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])] * t)
    assert jvalidate.metric_val(pred, gt, poses, ks) == validate.metric_val(pred, gt, poses, ks)


def test_evaluate_functions_bit_for_bit(tmp_path):
    import cv2

    pred, gt, _ = depth_batch(3)
    disp = 1.0 / pred
    valid = (gt > 1e-3) & (gt < 10.0)
    assert jevaluate.eval_sequence(disp, gt, 10.0) == evaluate.eval_sequence(disp, gt, 10.0)
    assert (jevaluate.align_disparity_lstsq(disp, gt, valid)
            == evaluate.align_disparity_lstsq(disp, gt, valid))
    d16 = (gt[0] * 1000).astype(np.uint16)
    d16[0, :4] = 0
    cv2.imwrite(str(tmp_path / "d.png"), d16)
    np.save(tmp_path / "d.npy", gt[0])
    np.save(tmp_path / "p.npy", disp[0][:20, :30].astype(np.float32))
    cv2.imwrite(str(tmp_path / "p.png"), (disp[0] * 100).astype(np.uint8))
    for p, f in (("d.png", 1000.0), ("d.npy", 1.0)):
        np.testing.assert_array_equal(evaluate.load_gt_depth(str(tmp_path / p), f),
                                      jevaluate.load_gt_depth(str(tmp_path / p), f))
    for p in ("p.npy", "p.png"):
        for size in (None, (24, 32)):
            np.testing.assert_array_equal(evaluate.load_infer(str(tmp_path / p), size),
                                          jevaluate.load_infer(str(tmp_path / p), size))
    for ds in ("kitti", "sintel", "nyuv2_500", "scannet", "vkitti"):
        assert vars(evaluate.dataset_eval_config(ds, "B")) == vars(
            jevaluate.dataset_eval_config(ds, "B"))


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = osp.join(dirpath, f)
            out[osp.relpath(p, root)] = open(p, "rb").read()
    return out


def _scannet_raw(root, rng):
    seq = root / "scene0000_00"
    for i in range(4):
        _write_rgb(str(seq / "color" / f"{i:06d}.jpg"), rng)
        _write_depth16(str(seq / "depth" / f"{i:06d}.png"), 1000, 9000, i)
        os.makedirs(seq / "pose", exist_ok=True)
        pose = np.eye(4)
        pose[:3, 3] = [0.01 * i, 0.0, 0.0]
        np.savetxt(seq / "pose" / f"{i:06d}.txt", pose)
    os.makedirs(seq / "intrinsic", exist_ok=True)
    np.savetxt(seq / "intrinsic" / "intrinsic_depth.txt",
               np.array([[30.0, 0, 40, 0], [0, 30.0, 32, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))


def _raw_tree(dataset, tmp):
    """(raw root, depth root) in the layout each extractor reads."""
    rng = np.random.default_rng(len(dataset))
    root, depth_root = tmp / "raw", tmp / "depth_anno"
    if dataset == "kitti":
        seq = "2011_09_26_drive_0001_sync"
        for i in range(3):
            name = f"{i:010d}.png"
            _write_rgb(str(root / seq[:10] / seq / "image_02" / "data" / name), rng)
            _write_depth16(str(depth_root / seq / "proj_depth" / "groundtruth" / "image_02" / name),
                           256 * 2, 256 * 40, i)
    elif dataset == "bonn":
        depth_root = root
        for i in range(33):
            name = f"frame_{i:04d}.png"
            _write_rgb(str(root / "balloon" / "rgb" / name), rng)
            _write_depth16(str(root / "balloon" / "depth" / name), 5000, 45000, i)
    elif dataset == "sintel":
        for i in range(3):
            _write_rgb(str(root / "alley_1" / f"frame_{i:04d}.png"), rng)
            d = (100.0 + 40.0 * rng.random((RAW_H, RAW_W)) + i).astype(np.float32)
            os.makedirs(depth_root / "alley_1", exist_ok=True)
            (depth_root / "alley_1" / f"frame_{i:04d}.dpt").write_bytes(_dpt_bytes(d))
    elif dataset == "nyuv2":
        for i in range(3):
            _write_rgb(str(root / "kitchen" / "rgb" / f"img_{i:04d}.png"), rng)
            _write_depth16(str(root / "kitchen" / "depth" / f"img_{i:04d}.png"), 6000, 54000, i)
    elif dataset == "scannet":
        _scannet_raw(root, rng)
    else:   # vkitti
        for cam in ("Camera_0", "Camera_1"):
            for i in range(3):
                _write_rgb(str(root / "vkitti_2.0.3_rgb" / "Scene20" / "clone" / "frames" / "rgb"
                               / cam / f"rgb_{i:05d}.jpg"), rng)
                _write_depth16(str(root / "vkitti_2.0.3_depth" / "Scene20" / "clone" / "frames"
                                   / "depth" / cam / f"depth_{i:05d}.png"), 200, 7000, i)
    return str(root), str(depth_root)


def _extract(mod, dataset, root, depth_root, saved):
    if dataset in ("kitti", "bonn", "sintel"):
        getattr(mod, f"extract_{dataset}")(root, depth_root, saved)
    else:
        getattr(mod, f"extract_{dataset}")(root, saved)


@pytest.mark.parametrize("dataset", ["kitti", "bonn", "sintel", "nyuv2", "scannet", "vkitti"])
def test_extractors_write_the_same_files(dataset, tmp_path):
    root, depth_root = _raw_tree(dataset, tmp_path)
    _extract(jextract, dataset, root, depth_root, str(tmp_path / "jax"))
    _extract(extract, dataset, root, depth_root, str(tmp_path / "port"))
    a, b = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert sorted(a) == sorted(b) and len(a) > 2
    for k in a:   # manifests name paths under their own root: compare them relative
        if k.endswith(".json"):
            ja, jb = (json.loads(x.decode().replace(str(tmp_path / d), "R"))
                      for x, d in ((a[k], "jax"), (b[k], "port")))
            assert ja == jb, k
        else:
            assert a[k] == b[k], k


def test_manifests_same_json(tmp_path):
    root, _ = _raw_tree("scannet", tmp_path)
    _extract(extract, "scannet", root, None, str(tmp_path / "bench"))
    out = str(tmp_path / "bench" / "scannet")
    for kw in (dict(), dict(start_id=1, end_id=3, step=1), dict(start_id=0, end_id=-1, step=2)):
        assert manifests.gen_json(out, "scannet", **kw) == jmanifests.gen_json(out, "scannet", **kw)
    assert manifests.gen_json_scannet_tae(out, 0, 3) == jmanifests.gen_json_scannet_tae(out, 0, 3)
    names = ["f10.png", "f2.png", "a1", "f1.png"]
    assert manifests.natsorted(names) == jmanifests.natsorted(names)
    assert manifests.DATASET_FACTORS == jmanifests.DATASET_FACTORS


def test_validation_pngs_byte_for_byte(tmp_path):
    rng = np.random.default_rng(4)
    video = rng.standard_normal((5, 20, 24, 3)).astype(np.float32)
    gt = rng.random((5, 20, 24)).astype(np.float32)
    mask = (rng.random((5, 20, 24)) > 0.3).astype(np.float32)
    pred = rng.random((5, 20, 24)).astype(np.float32)
    a = jvisualize.dump_val_frames(str(tmp_path / "j"), 3, video, gt, mask, pred)
    b = visualize.dump_val_frames(str(tmp_path / "t"), 3, video, gt, mask, pred)
    assert [osp.basename(p) for p in a] == [osp.basename(p) for p in b] and len(b) == 4
    for p, q in zip(a, b):
        assert open(p, "rb").read() == open(q, "rb").read()


_KW = dict(encoder="_tinybench", features=32, out_channels=(32, 32, 32, 32), num_frames=32,
           taps=(0, 0, 1, 1))


def test_infer_manifest_then_evaluate(tmp_path):
    import cv2

    root = tmp_path / "bonn"
    rng = np.random.default_rng(0)
    (root / "seq" / "rgb").mkdir(parents=True)
    (root / "seq" / "depth").mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(root / "seq" / "rgb" / f"{i:04d}.png"),
                    rng.integers(0, 255, (42, 56, 3), np.uint8))
        cv2.imwrite(str(root / "seq" / "depth" / f"{i:04d}.png"),
                    rng.integers(5000, 50000, (42, 56)).astype(np.uint16))
    json_file = str(root / "bonn_video.json")
    manifests.gen_json(str(root), "bonn", save_path=json_file)
    jcfg = JModelConfig(vit_override=JViTConfig(embed_dim=64, depth=2, num_heads=2), **_KW)
    cfg = ModelConfig(vit_override=ViTConfig(embed_dim=64, depth=2, num_heads=2), **_KW)
    params = jax.tree.map(np.asarray, init_params(0, jcfg))
    jpipe = JPipeline(jcfg, init_params(0, jcfg), use_pallas=False)
    pipe = VideoDepthPipeline(cfg, model_from_params(params, cfg), device="cpu")
    assert jinfer.infer_manifest(jpipe, json_file, "bonn", str(tmp_path / "j"), 28) == 1
    assert infer.infer_manifest(pipe, json_file, "bonn", str(tmp_path / "t"), 28) == 1
    for i in range(4):
        rel = osp.join("bonn", "seq", "rgb", f"{i:04d}.npy")
        a, b = np.load(tmp_path / "j" / rel), np.load(tmp_path / "t" / rel)
        assert b.shape == a.shape == (42, 56) and b.dtype == a.dtype
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4 * max(float(np.ptp(a)), 1.0))
    ecfg = evaluate.DatasetEvalConfig(json_file=json_file, root_path=str(root),
                                      max_depth_eval=10.0, min_depth_eval=0.1,
                                      max_eval_len=110, crop=(0, 42, 0, 56), name="bonn")
    ja = jevaluate.eval_dataset(str(tmp_path / "j"), ecfg)
    tb = evaluate.eval_dataset(str(tmp_path / "t"), ecfg)
    assert sorted(ja) == sorted(tb)
    for k in ja:
        np.testing.assert_allclose(tb[k], ja[k], rtol=1e-3)
    with pytest.raises(ValueError, match="no predictions"):
        evaluate.eval_dataset(str(tmp_path / "none"), ecfg)
