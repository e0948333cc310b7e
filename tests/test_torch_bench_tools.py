"""The port's A/B bench tool ``tools/bench_wgmma.py`` on the CPU: it exits 2
without a card (it measures nothing here), and its shape lists are
PERF.md's kernel-table shapes for K3 and K2, the ones the old / new runs
are compared at."""
import sys

import torch

from video_depth_anything_torch.tools import bench_wgmma


def test_bench_wgmma_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["bench_wgmma", "--label", "cpu"])
    assert bench_wgmma.main() == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_bench_wgmma_k3_shapes_are_the_encoder_shapes():
    """(label, B, S, H): the int8 main path's cached window and the vits and
    vitl 518^2 windows, head dim 64."""
    assert [shape[1:] for shape in bench_wgmma.K3_SHAPES] == [
        (22, 1814, 6), (32, 1370, 6), (32, 1370, 16)]


def test_bench_wgmma_k2_shapes_are_the_motion_module_shapes():
    """(P, C) of motion modules 0-3 of vits 518^2, vitl 518^2 and vits
    518x686 (the main path's), each at T = 32 with 8 heads."""
    assert (bench_wgmma.K2_FRAMES, bench_wgmma.K2_HEADS) == (32, 8)
    assert [shape[1:] for shape in bench_wgmma.K2_SHAPES] == [
        (1369, 192), (361, 384), (1369, 64), (5476, 64),
        (1369, 1024), (361, 1024), (1369, 256), (5476, 256),
        (1813, 192), (475, 384), (1813, 64), (7252, 64)]
    assert len({shape[0] for shape in bench_wgmma.K2_SHAPES}) == 12   # labels tell them apart
