"""Command line of the port (counterpart of efficientat_tpu/cli.py).

- ``tag``: tag a single clip and print the top-10 labels
  (reference surface: upstream inference.py); ``--bf16`` runs the model
  under bf16 autocast (the mel stays fp32);
- ``windowed-tag``: tag a long recording in sliding windows and print the
  top-3 labels of each (upstream windowed_inference.py);
- ``train <task>``: train or fine-tune on a task preset (upstream
  ex_audioset.py, ex_esc50.py, ...), in one process or under
  ``torchrun --nproc_per_node N -m efficientat_tpu_torch.cli train <task>``;
- ``evaluate <task>``: evaluate weights on a task's eval split;
- ``complexity``: MACs and parameters, or analytic peak memory, of a
  registry model (upstream complexity.py), or a transformer's MACs;
- ``profile``: a ``torch.profiler`` trace of ``Tagger.predict`` with its
  spans, then the device's busy share and its idle time by span;
- ``receptive-field``: the analytic receptive field (upstream
  receptive_field_cnn.py);
- ``convert-dataset``: a reference mp3-HDF5 to an int16 PCM HDF5.

Run ``python -m efficientat_tpu_torch.cli tag --help``; ``train`` and
``evaluate`` pass their remaining flags to the task's own parser
(``train/cli.py``).
"""

from __future__ import annotations

import argparse
import os
import tempfile


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
    p.set_defaults(fn=_run_tag)


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
    p.set_defaults(fn=_run_windowed)


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


def _add_complexity(sub):
    p = sub.add_parser("complexity", help="MACs / params / analytic peak memory")
    p.add_argument("--model_name", type=str, default="mn10_as")
    p.add_argument("--measure", choices=["macs", "memory"], default="macs")
    p.add_argument("--bits", type=int, default=16)
    p.add_argument("--clip_seconds", type=float, default=10.0)
    # transformer mode: static PaSST/ViT-style MACs, no model needed
    # (reference helpers/flop_count.py:72-162 counts its KD teacher); the
    # defaults are the registry's PaSST-S
    from efficientat_tpu_torch.tools.macs import TransformerSpec

    passt = TransformerSpec()
    p.add_argument("--transformer", action="store_true")
    p.add_argument("--embed_dim", type=int, default=passt.embed_dim)
    p.add_argument("--depth", type=int, default=passt.depth)
    p.add_argument("--patch_size", type=int, default=passt.patch_size)
    p.add_argument("--stride", type=int, default=passt.stride_t)
    p.add_argument("--input_f", type=int, default=passt.input_f)
    p.add_argument("--input_t", type=int, default=passt.input_t)
    p.add_argument("--num_classes", type=int, default=passt.num_classes)
    p.set_defaults(fn=_run_complexity)


def _run_complexity(args):
    if args.transformer:
        from efficientat_tpu_torch.tools.macs import (
            TransformerSpec,
            count_macs_transformer,
        )

        spec = TransformerSpec(
            input_f=args.input_f, input_t=args.input_t,
            embed_dim=args.embed_dim, depth=args.depth,
            patch_size=args.patch_size, stride_f=args.stride,
            stride_t=args.stride, num_classes=args.num_classes)
        count_macs_transformer(spec, verbose=True)
        return

    from efficientat_tpu_torch.tools.complexity import report_complexity

    report_complexity(args.model_name, measure=args.measure, bits=args.bits,
                      clip_seconds=args.clip_seconds)


def _add_profile(sub):
    p = sub.add_parser("profile", help="Capture a device trace of a model forward")
    p.add_argument("--model_name", type=str, default="mn10_as")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--clip_seconds", type=float, default=10.0)
    p.add_argument("--log_dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "eatpu-trace"))
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda")
    p.set_defaults(fn=_run_profile)


def _run_profile(args):
    import numpy as np

    from efficientat_tpu_torch.infer.tag import Tagger
    from efficientat_tpu_torch.utils.profiling import idle_by_span, set_spans, take_spans, trace

    tagger = Tagger(args.model_name, pretrained=False, device=args.device)
    sr = tagger.mel_cfg.sr
    waves = np.random.default_rng(0).normal(
        size=(args.batch_size, int(args.clip_seconds * sr))).astype(np.float32) * 0.1
    tagger.predict(waves)  # the first call's set-up stays outside the trace
    with trace(args.log_dir) as path:
        set_spans(True)
        try:
            for _ in range(args.iters):
                tagger.predict(waves)
        finally:
            set_spans(False)
            take_spans()  # the trace holds them
    print(f"trace written to {args.log_dir} (view with TensorBoard/Perfetto)")
    idle = idle_by_span(path)
    if idle["busy_pct"] is None:
        print("no device rows in the trace")
        return
    print(f"device busy {idle['busy_pct']:.1f} % of {idle['window_ms']:.3f} ms "
          f"({args.iters} predicts)")
    print("device idle by span (ms): " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in idle["idle_ms"]))


def _add_rf(sub):
    p = sub.add_parser("receptive-field", help="Analytic receptive field (freq/time)")
    p.add_argument("--model_name", type=str, default="mn10_as")
    # manual MN configuration (reference receptive_field_cnn.py:26-35)
    p.add_argument("--model_width", type=float, default=None)
    p.add_argument("--head_type", type=str, default=None)
    p.add_argument("--strides", nargs=4, type=int, default=None)
    p.add_argument("--se_dims", type=str, default=None)
    # or an arbitrary conv stack, e.g. --layers 3:2,3:1:2,5x3:2x1
    p.add_argument("--layers", type=str, default=None,
                   help="generic CNN spec k:s[:d],... ; fields may be fxt pairs")
    p.set_defaults(fn=_run_rf)


def _run_rf(args):
    from efficientat_tpu_torch.tools.receptive_field import report_receptive_field

    report_receptive_field(args.model_name, model_width=args.model_width,
                           strides=args.strides, se_dims=args.se_dims,
                           head_type=args.head_type, layers=args.layers)


def _add_convert_dataset(sub):
    p = sub.add_parser(
        "convert-dataset",
        help="Convert a reference mp3-HDF5 to int16 PCM HDF5 (fast reads, "
             "int16 transport; ~8x larger on disk)")
    p.add_argument("--src", type=str, required=True, help="*_mp3.hdf input")
    p.add_argument("--dst", type=str, required=True, help="*_pcm.hdf output")
    p.add_argument("--sample_rate", type=int, default=32000)
    p.set_defaults(fn=_run_convert_dataset)


def _run_convert_dataset(args):
    from efficientat_tpu_torch.data.hdf5 import convert_mp3_hdf5_to_pcm

    convert_mp3_hdf5_to_pcm(args.src, args.dst, args.sample_rate)
    print(f"wrote {args.dst}")


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
    _add_complexity(sub)
    _add_profile(sub)
    _add_rf(sub)
    _add_convert_dataset(sub)
    args, extra = parser.parse_known_args(argv)
    if args.command in ("train", "evaluate"):
        from efficientat_tpu_torch.train.cli import run_evaluate, run_train

        (run_train if args.command == "train" else run_evaluate)(args.task, extra)
        return
    if extra:
        parser.error(f"unrecognized arguments: {extra}")
    args.fn(args)


if __name__ == "__main__":
    main()
