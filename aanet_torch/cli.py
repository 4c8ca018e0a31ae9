"""Command-line entry point of the PyTorch port:

  python -m aanet_torch.cli predict --preset aanet --data_dir pairs/ \\
      [--pretrained weights.pt] [--device cuda|cpu]

``pairs/`` holds ``left/*.png`` and ``right/`` with the same names. The
weights are a torch state_dict file (``aanet_torch.convert`` maps a flax
checkpoint's trees onto one). Float32 convolutions and matmuls run in full
float32 (TF32 off), as the JAX package's float32 mode does.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging

import torch

from aanet_torch.config import preset


def cmd_predict(args):
    from aanet_torch.infer import predict_pairs

    cfg = preset(args.preset)
    if args.max_disp is not None:
        cfg = dataclasses.replace(cfg, max_disp=args.max_disp)
    predict_pairs(
        cfg, args.data_dir, output_dir=args.output_dir, save_type=args.save_type,
        visualize=args.visualize, pretrained=args.pretrained, device=args.device,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(prog="aanet_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("predict", help="predict disparities of rectified pairs")
    p.add_argument("--preset", default="aanet")
    p.add_argument("--max_disp", type=int, default=None,
                   help="override the preset's max_disp (as the weights were trained)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--pretrained", default=None, help="torch state_dict file")
    p.add_argument("--save_type", default="png", choices=["png", "pfm", "npy"])
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    p.set_defaults(fn=cmd_predict)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args.fn(args)


if __name__ == "__main__":
    main()
