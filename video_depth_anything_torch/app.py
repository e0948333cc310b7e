"""Gradio demo of the port (the counterpart of the repository's root
``app.py``).

ViT-L relative depth with max_len / target_fps / max_res sliders,
returning (processed source mp4, depth visualization mp4).
``process_video`` is importable without gradio for programmatic use; the
demo itself needs gradio, which is imported only when the demo is built.
The pipeline runs on the card.

    python -m video_depth_anything_torch.app
"""
from __future__ import annotations

import os
import sys

_PIPELINE = {}


def _get_pipeline(encoder: str = "vitl"):
    """The pipeline for ``encoder``, built once: the checkpoint found by
    the default lookup (``./checkpoints``, ``.npz`` before ``.pth``), else
    seeded random weights with a warning."""
    if encoder not in _PIPELINE:
        from .config import get_model_config
        from .convert import load_checkpoint
        from .models import build_model
        from .pipeline import VideoDepthPipeline
        from .pipeline.infer import resolve_device
        from .utils import params_io

        cfg = get_model_config(encoder)
        device = resolve_device()
        ckpt = params_io.resolve_checkpoint(encoder)
        if ckpt:
            model = load_checkpoint(build_model(cfg, device=device), ckpt)
        else:
            print("WARNING: no checkpoint found — using random weights")
            model = build_model(cfg, seed=0, device=device)
        _PIPELINE[encoder] = VideoDepthPipeline(cfg, model, device=device)
    return _PIPELINE[encoder]


def process_video(video_path: str, max_len: int = 500, target_fps: int = 15,
                  max_res: int = 1280, output_dir: str = "./outputs",
                  grayscale: bool = False):
    """-> (src_video_path, vis_video_path): the decoded frames and their
    depth visualization as mp4 files in ``output_dir``."""
    from .utils.video_io import read_video_frames, save_video

    pipe = _get_pipeline()
    frames, fps = read_video_frames(video_path, max_len, target_fps, max_res)
    depths, fps = pipe.infer_video_depth(frames, fps)
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(video_path))[0]
    src = os.path.join(output_dir, stem + "_src.mp4")
    vis = os.path.join(output_dir, stem + "_vis.mp4")
    save_video(frames, src, fps=fps)
    save_video(depths, vis, fps=fps, is_depths=True, grayscale=grayscale)
    return src, vis


def construct_demo():
    import gradio as gr

    with gr.Blocks(title="Video Depth Anything (PyTorch / CUDA)") as demo:
        gr.Markdown("# Video Depth Anything\nConsistent depth for arbitrarily long videos.")
        with gr.Row():
            inp = gr.Video(label="Input video")
            out_src = gr.Video(label="Processed source")
            out_vis = gr.Video(label="Depth visualization")
        with gr.Row():
            max_len = gr.Slider(1, 1000, value=500, step=1, label="max length")
            fps = gr.Slider(-1, 60, value=15, step=1, label="target fps")
            max_res = gr.Slider(196, 1920, value=1280, step=14, label="max res")
        btn = gr.Button("Generate")
        btn.click(lambda v, l, f, r: process_video(v, int(l), int(f), int(r)),
                  inputs=[inp, max_len, fps, max_res], outputs=[out_src, out_vis])
    return demo


def main() -> None:
    try:
        import gradio  # noqa: F401
    except ImportError:
        sys.exit("gradio is not installed in this image; use run.py for the "
                 "CLI, or `pip install gradio` in a full environment")
    demo = construct_demo()
    demo.queue()
    demo.launch(share=True)


if __name__ == "__main__":
    main()
