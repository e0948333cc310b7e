"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Every wrapper counts its kernel launches in a plain integer attribute
(``wrapper.launches``); ``reset_launch_counts`` and ``launch_counts`` read
them all, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from . import (attention_head_major, attention_variants, fused_rcu, qk_probes,
               spatial_attention, spatial_attention_qk8, spatial_attention_qkv,
               temporal_attention)

KERNELS = {
    "spatial_attention": spatial_attention.spatial_attention,
    "temporal_attention": temporal_attention.temporal_attention,
    "spatial_attention_qk8": spatial_attention_qk8.spatial_attention_qk8,
    "attention_head_major": attention_head_major.attention_head_major,
    "spatial_attention_qkv_fused": spatial_attention_qkv.spatial_attention_qkv_fused,
    "fused_rcu": fused_rcu.fused_rcu,
    # The measurement kernels of the bench tools (tools/bench_kernel_*.py).
    "phase_probes": qk_probes.phase_probe,
    "attention_variants": attention_variants.attention_variant,
    "qk_probes": qk_probes.qk_probe,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
