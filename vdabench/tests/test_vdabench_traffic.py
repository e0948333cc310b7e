"""The traffic generator: the same seed gives the same clips and frames,
and every seed sends the same set of clip lengths."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from vdabench import spec, traffic
from vdabench.tests import tiny


def _first(gen, n):
    return list(itertools.islice(gen, n))


def test_clips_are_deterministic_from_the_seed():
    tr = spec.load_cell("vits-720p-shortclips-c4").traffic
    assert _first(traffic.clips(tr, 2**31 + 5), 40) == _first(traffic.clips(tr, 2**31 + 5), 40)
    assert _first(traffic.clips(tr, 1), 40) != _first(traffic.clips(tr, 2), 40)


def test_every_seed_sends_the_same_lengths():
    tr = spec.load_cell("vitl-720p-clips").traffic
    lens = sorted(traffic.lengths(tr))
    assert lens[0] == tr["clip_frames"][0] and lens[-1] == tr["clip_frames"][1]
    for seed in (0, 7, 2**32 + 3):
        cycle = _first(traffic.clips(tr, seed), 2 * len(lens))
        assert sorted(n for _, _, n in cycle[:len(lens)]) == lens
        assert sorted(n for _, _, n in cycle[len(lens):]) == lens
        assert all(0 <= s and s + n <= tr["pool_frames"] for _, s, n in cycle)


def test_warmup_covers_every_length_of_the_batched_cell():
    tr = spec.load_cell("vits-720p-shortclips-c4").traffic
    assert sorted(tr["warmup_lengths"]) == sorted(traffic.lengths(tr))


def test_frame_pool_is_deterministic_from_the_seed():
    tr = dict(tiny.TRAFFIC)
    a = traffic.frame_pool(tr, 11, torch.device("cpu"))
    b = traffic.frame_pool(tr, 11, torch.device("cpu"))
    c = traffic.frame_pool(tr, 12, torch.device("cpu"))
    assert a.dtype == np.uint8 and a.shape == (tr["pool_frames"], *tr["source_hw"], 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert 20 < a.std() < 100   # a scene, not a constant


def test_check_sample_is_drawn_from_the_seed():
    wl = spec.load_cell("vits-720p-shortclips-c4").workload
    s = traffic.check_sample(wl, 9)
    assert s == traffic.check_sample(wl, 9) and len(s) == wl["check"]["clips"]
    assert all(0 <= o < wl["check"]["from_first"] for o in s)
