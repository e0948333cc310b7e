"""Convert a reference torch checkpoint (``.pth``) to the native ``.npz``
(the port of the JAX package's ``tools/convert_checkpoint.py``): the
parameter tree of ``convert.params_from_state_dict``, flattened to
'/'-joined keys (``utils/params_io.py::save_params``), the file either
package's ``--checkpoint`` reads. Host-side; no device.

    python -m video_depth_anything_torch.tools.convert_checkpoint \\
        checkpoints/video_depth_anything_vitl.pth [--encoder vits] [--out ckpt.npz]
"""
from __future__ import annotations

import argparse
import os
import sys


def infer_encoder(path: str) -> str | None:
    """The encoder named in the file's name: vits, vitb, vitl or vitg."""
    for cand in ("vits", "vitb", "vitl", "vitg"):
        if cand in os.path.basename(path):
            return cand
    return None


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint")
    parser.add_argument("--encoder", default=None,
                        help="vits/vitl (inferred from filename if omitted)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from ..config import get_model_config
    from ..convert import load_torch_checkpoint
    from ..utils.params_io import save_params

    enc = args.encoder or infer_encoder(args.checkpoint)
    if enc is None:
        sys.exit("cannot infer encoder from filename; pass --encoder")
    try:
        cfg = get_model_config(enc)
    except KeyError:
        sys.exit(f"no model config for encoder '{enc}' "
                 f"(supported: vits, vitl); pass --encoder")
    params = load_torch_checkpoint(args.checkpoint, cfg.vit.depth)
    out = args.out or os.path.splitext(args.checkpoint)[0] + ".npz"
    save_params(out, params)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
