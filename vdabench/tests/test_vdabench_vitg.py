"""The vitg cell: its files resolve and pass the harness's ``validate``,
K8's byte count at vitg's 518x924 window is the arithmetic PERF.md gives,
and the two new per-layer metrics read what a traced run would hand them
(a fabricated context), None where a program has nothing to read."""
from __future__ import annotations

import types

import pytest

from vdabench import counts, infer, spec
from vdabench.reference import pipeline as ref_pipeline
from video_depth_anything_torch.utils import profiling

# PERF.md §3: per frame at 518x924, (37 * 66 + 1) tokens x 40 blocks x 3 x 4096 x 2 bytes.
VITG_BYTES_PER_FRAME = 2443 * 40 * 3 * 4096 * 2


def test_the_new_cell_resolves_and_validates():
    c = spec.load_cell("vitg-720p-clips")
    infer.validate(c)
    assert (c.workload["config"], c.workload["traffic"], c.workload["chips"]) == \
        ("vda-vitg", "720p-clips", 1)
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "peak_mem_gib", "setup_s"}
    assert c.workload["check"] == {"clips": 1, "from_first": 4}
    assert set(c.workload["limits"]) == {"mean_err_pct", "max_err_pct", "tap_err_pct",
                                         "branch_err_pct"}


def test_the_vitg_configuration_is_the_published_one():
    cfg = spec.load_cell("vitg-720p-clips").config
    assert (cfg["embed_dim"], cfg["depth"], cfg["num_heads"], cfg["mlp_ratio"]) == \
        (1536, 40, 24, 4)
    assert cfg["ffn_layer"] == "swiglufused" and cfg["taps"] == [9, 19, 29, 39]
    assert (cfg["features"], cfg["out_channels"], cfg["motion_heads"]) == (384, [1536] * 4, 8)
    assert cfg["reduced"] == [] and cfg["dtype"] == "bfloat16"
    from video_depth_anything_torch.models.dinov2 import swiglu_hidden

    assert _roofline_module().hidden(cfg) == swiglu_hidden(1536, 4) == 4096


def _roofline_module():
    import importlib.util

    spec_ = importlib.util.spec_from_file_location(
        "vdabench_metric_swiglu_test", spec.metric_file("kernel.swiglu_roofline"))
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def test_k8_bytes_at_vitgs_518x924_window():
    cell = spec.load_cell("vitg-720p-clips")
    net_hw = ref_pipeline.network_size(*cell.traffic["source_hw"], cell.traffic["input_size"])
    assert net_hw == (518, 924)
    ph, pw = net_hw[0] // 14, net_hw[1] // 14
    mod = _roofline_module()
    assert VITG_BYTES_PER_FRAME == 2_401_566_720
    assert mod.swiglu_bytes(cell.config, 1, ph, pw) == VITG_BYTES_PER_FRAME
    assert mod.swiglu_bytes(cell.config, 32, ph, pw) == 32 * VITG_BYTES_PER_FRAME
    # one launch of a 32-frame window: 1.92 GB, 0.573 ms at 3.35 TB/s
    per_launch = 32 * VITG_BYTES_PER_FRAME / 40
    assert counts.bound_s(0.0, per_launch) * 1e3 == pytest.approx(0.5735, abs=5e-5)


class _Profile:
    def __init__(self, frames, kernel_s):
        self.calls = {"encode_frames": frames, "head_windows": [1] * len(frames)}
        self._t = kernel_s

    def kernel_s(self, patterns):
        return self._t if patterns == ("swiglu_bf16",) else 0.0


def _ctx(config, profile):
    return types.SimpleNamespace(counts=counts, config=config, profile=profile, ph=37, pw=66)


def test_swiglu_roofline_reads_the_bound_over_the_kernels_time():
    cfg = spec.load_cell("vitg-720p-clips").config
    read = spec.metric_reader("kernel.swiglu_roofline")
    bound = 2 * 32 * VITG_BYTES_PER_FRAME / counts.PEAK_BYTES
    assert read(_ctx(cfg, _Profile([32, 32], bound / 0.8))) == pytest.approx(80.0)
    assert read(_ctx(cfg, _Profile([32], 0.0))) is None          # no K8 ran: the parent
    assert read(_ctx(cfg, None)) is None                          # a run on the CPU
    vitl = spec.load_cell("vitl-720p-clips").config
    assert read(_ctx(vitl, _Profile([32], 1.0))) is None          # no fused SwiGLU


@pytest.mark.parametrize("row,want", [
    ({"count": 80, "host_s": 0.1, "self_s": 0.1, "device_s": 0.0, "counters": {"fused": 80}},
     100.0),
    ({"count": 80, "host_s": 0.1, "self_s": 0.1, "device_s": 0.0, "counters": {"fused": 0}},
     0.0),
    (None, None)])
def test_fused_share_reads_the_spans_counter(row, want, monkeypatch):
    table = {"vda.encoder": {"count": 2, "host_s": 1.0, "self_s": 0.1, "device_s": 1.0,
                             "counters": {"frames": 64}}}
    if row is not None:
        table["vda.encoder.swiglu"] = row
    monkeypatch.setattr(profiling, "totals", lambda: table)
    read = spec.metric_reader("model.encoder_swiglu_fused_share")
    cfg = spec.load_cell("vitg-720p-clips").config
    assert read(_ctx(cfg, _Profile([32], 1.0))) == want
    assert read(_ctx(cfg, None)) is None
