"""Command line of the port (counterpart of efficientat_tpu/cli.py).

- ``tag``: tag a single clip and print the top-10 labels
  (reference surface: upstream inference.py); ``--bf16`` runs the model
  under bf16 autocast (the mel stays fp32);
- ``windowed-tag``: tag a long recording in sliding windows and print the
  top-3 labels of each (upstream windowed_inference.py);
- ``train <task>``: train or fine-tune on a task preset (upstream
  ex_audioset.py, ex_esc50.py, ...), in one process or under
  ``torchrun --nproc_per_node N -m efficientat_tpu_torch.cli train <task>``;
- ``evaluate <task>``: evaluate weights on a task's eval split.

Run ``python -m efficientat_tpu_torch.cli tag --help``; ``train`` and
``evaluate`` pass their remaining flags to the task's own parser
(``train/cli.py``).
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
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 model compute (mel stays fp32)")
    p.add_argument("--device", type=str, default="cuda")


def _run_tag(args):
    import torch

    from efficientat_tpu_torch.infer.tag import Tagger

    names = args.ensemble if args.ensemble else args.model_name
    tagger = Tagger(names, pretrained=not args.no_pretrained,
                    model_dir=args.model_dir, device=args.device,
                    dtype=torch.bfloat16 if args.bf16 else torch.float32)
    tags = tagger.tag(args.audio_path)
    print("************* Acoustic Event Detected: *****************")
    for label, prob in tags:
        print(f"{label}: {prob:.3f}")
    print("********************************************************")


def _add_windowed(sub):
    p = sub.add_parser("windowed-tag", help="Tag a long recording in sliding windows")
    p.add_argument("--model_name", type=str, default="mn10_as")
    p.add_argument("--audio_path", type=str, required=True)
    p.add_argument("--window_size", type=float, default=10.0)
    p.add_argument("--hop_length", type=float, default=2.5)
    p.add_argument("--max_batch", type=int, default=None)
    p.add_argument("--no-pretrained", action="store_true")
    p.add_argument("--model_dir", type=str, default="resources")
    p.add_argument("--device", type=str, default="cuda")


def _run_windowed(args):
    from efficientat_tpu_torch.infer.tag import Tagger
    from efficientat_tpu_torch.infer.windowed import tag_audio_window

    tagger = Tagger(args.model_name, pretrained=not args.no_pretrained,
                    model_dir=args.model_dir, device=args.device)
    results = tag_audio_window(tagger, args.audio_path, args.window_size,
                               args.hop_length, max_batch=args.max_batch)
    for r in results:
        print(f"[{r['start']:8.2f}s - {r['end']:8.2f}s]")
        for label, prob in r["tags"][:3]:
            print(f"    {label}: {prob:.3f}")


def _add_task_command(sub, name, help):
    from efficientat_tpu_torch.train.tasks import TASKS

    # no -h here: ``train <task> --help`` reaches the task's own parser
    p = sub.add_parser(name, help=help, add_help=False)
    p.add_argument("task", choices=list(TASKS))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="efficientat_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_tag(sub)
    _add_windowed(sub)
    _add_task_command(sub, "train", "Train / fine-tune on a task preset")
    _add_task_command(sub, "evaluate", "Evaluate a model on a task's eval split")
    args, extra = parser.parse_known_args(argv)
    if args.command in ("tag", "windowed-tag"):
        if extra:
            parser.error(f"unrecognized arguments: {extra}")
        (_run_tag if args.command == "tag" else _run_windowed)(args)
        return
    from efficientat_tpu_torch.train.cli import run_evaluate, run_train

    (run_train if args.command == "train" else run_evaluate)(args.task, extra)


if __name__ == "__main__":
    main()
