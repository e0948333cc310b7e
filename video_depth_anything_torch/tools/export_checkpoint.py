"""Export a training checkpoint of the port (``training/checkpoint.py``:
``best_checkpoint`` / ``latest_checkpoint``) to an inference ``.npz`` that
``run.py --checkpoint`` of either package reads (the port of the JAX
package's ``tools/export_checkpoint.py``). The model's state dict in the
checkpoint becomes the parameter tree (``convert.params_from_state_dict``)
and is written by ``utils/params_io.py::save_params``. Host-side.

    python -m video_depth_anything_torch.tools.export_checkpoint train_out \\
        --name best_checkpoint --encoder vits --out checkpoints/video_depth_anything_vits.npz
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("train_dir")
    parser.add_argument("--name", default="best_checkpoint",
                        choices=["best_checkpoint", "latest_checkpoint"])
    parser.add_argument("--encoder", required=True)
    parser.add_argument("--clip_len", type=int, default=20)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    from ..config import get_model_config
    from ..convert import params_from_state_dict
    from ..training import checkpoint as ckpt
    from ..utils.params_io import save_params

    cfg = get_model_config(args.encoder, num_frames=args.clip_len)
    restored = ckpt.load_checkpoint(args.train_dir, args.name)
    if restored is None:
        sys.exit(f"no {args.name} under {args.train_dir}")
    save_params(args.out, params_from_state_dict(restored["params"], cfg.vit.depth))
    print(f"wrote {args.out} (epoch {restored['extra']['epoch']})")


if __name__ == "__main__":
    main()
