"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Every kernel the model calls is a ``torch.library`` custom op in the
``vda`` namespace, registered when this package is imported:
``vda::spatial_attention`` (K1, with its route to K4 for dh != 64),
``vda::spatial_attention_qk8`` (K3, with its fallback),
``vda::temporal_attention`` (K2) and ``vda::temporal_attention_backward``
(its gradient), ``vda::spatial_attention_qkv_fused`` (K5),
``vda::attention_head_major`` (K4, the functional form),
``vda::fused_rcu`` (K6), ``vda::head_output_tail`` (K7) and
``vda::swiglu`` (K8, vitg's SwiGLU gate). Each op's CPU
implementation is the kernel's plain version, its CUDA implementation the
kernel through its ctypes binding (a failed build or launch raises), and
its fake implementation gives the output's shape, dtype and strides
without reading the inputs, so
``torch.export`` records the op whatever device it traces on
(``utils/serving_export.py``) and a shapes-only run on the ``meta`` device
goes through. The Python wrappers refuse a gradient (``grad.py``) and then
call the op; K2's autograd Function wraps its op, and its backward calls
the backward op (``temporal_attention_backward``), which runs only under a
gradient.

Every wrapper counts its kernel launches in a plain integer attribute
(``wrapper.launches``), incremented inside the op's CUDA implementation
where it launches, so an exported program's calls count as live ones and
the trace counts nothing; ``reset_launch_counts`` and ``launch_counts``
read them all, so a run can show that its main path went through the
kernels. The measurement kernels T1-T3 (``qk_probes.py``,
``attention_variants.py``) are on no served path and stay plain Python
wrappers.
"""
from __future__ import annotations

from . import (attention_head_major, attention_variants, fused_rcu, head_output_tail,
               qk_probes, spatial_attention, spatial_attention_qk8, spatial_attention_qkv,
               swiglu, temporal_attention)

KERNELS = {
    "spatial_attention": spatial_attention.spatial_attention,
    "temporal_attention": temporal_attention.temporal_attention,
    "temporal_attention_backward": temporal_attention.temporal_attention_backward,
    "spatial_attention_qk8": spatial_attention_qk8.spatial_attention_qk8,
    "attention_head_major": attention_head_major.attention_head_major,
    "spatial_attention_qkv_fused": spatial_attention_qkv.spatial_attention_qkv_fused,
    "fused_rcu": fused_rcu.fused_rcu,
    "head_output_tail": head_output_tail.head_output_tail,
    "swiglu": swiglu.swiglu,
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
