"""Command line of the port (counterpart of efficientat_tpu/cli.py).

- ``tag``: tag a single clip and print the top-10 labels
  (reference surface: upstream inference.py).

Run ``python -m efficientat_tpu_torch.cli tag --help``.
"""

from __future__ import annotations

import argparse


def _add_tag(sub):
    p = sub.add_parser("tag", help="Tag a single audio clip (top-10 labels)")
    p.add_argument("--model_name", type=str, default="mn10_as")
    p.add_argument("--ensemble", nargs="+", default=[])
    p.add_argument("--audio_path", type=str, required=True)
    p.add_argument("--no-pretrained", action="store_true",
                   help="random weights (pipeline testing without checkpoints)")
    p.add_argument("--model_dir", type=str, default="resources")
    p.add_argument("--device", type=str, default="cuda")
    p.set_defaults(fn=_run_tag)


def _run_tag(args):
    from efficientat_tpu_torch.infer.tag import Tagger

    names = args.ensemble if args.ensemble else args.model_name
    tagger = Tagger(names, pretrained=not args.no_pretrained,
                    model_dir=args.model_dir, device=args.device)
    tags = tagger.tag(args.audio_path)
    print("************* Acoustic Event Detected: *****************")
    for label, prob in tags:
        print(f"{label}: {prob:.3f}")
    print("********************************************************")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="efficientat_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_tag(sub)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
