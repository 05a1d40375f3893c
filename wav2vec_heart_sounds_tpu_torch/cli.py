"""Command-line entry point (port of ``wav2vec_heart_sounds_tpu/cli.py``), on argparse.

The JAX CLI's commands with the same names, options, defaults and choices: ``make-splits``,
``summarize``, ``gen-train``, ``gen-sample``, ``classify-cinc``, ``classify-vest``,
``classify-synthetic``, ``classify-lsdo`` and ``bench`` (the ``train``, ``infer`` and
``preproc`` modes of :mod:`.bench`, data-parallel under ``torchrun``). It is written with
argparse because the card's machine has no click. One option is new, the top-level
``--device`` (default ``cuda``): the commands that build a model run there, and ``cuda``
without a card is an error, never the CPU. The compute dtype follows the device
(:func:`.models.build.default_compute_dtype`), as the JAX CLI's follows the backend. Each
command imports its modules when it runs.

Run it as ``python -m wav2vec_heart_sounds_tpu_torch.cli [--device cpu] <command> ...`` or,
installed, ``w2vhs-torch <command> ...``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _flag_pair(p: argparse.ArgumentParser, on: str, off: str, dest: str, default: bool,
               help: str | None = None) -> None:
    """click's ``--on/--off`` boolean pair."""
    p.add_argument(on, dest=dest, action="store_true", help=help)
    p.add_argument(off, dest=dest, action="store_false")
    p.set_defaults(**{dest: default})


def _flag(p: argparse.ArgumentParser, name: str, help: str | None = None) -> None:
    """click's ``is_flag=True, default=False``."""
    p.add_argument(name, action="store_true", default=False, help=help)


def _options(args: argparse.Namespace) -> dict:
    """The command's own options, as click hands them to the command."""
    return {k: v for k, v in vars(args).items() if k not in ("device", "run")}


def _placement(args: argparse.Namespace, bf16: bool = True) -> dict:
    """``device`` and ``dtype`` for the runners and builders; a missing card is an error."""
    import torch

    from .models.build import default_compute_dtype

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() is false "
                         "(pass --device cpu to run on the CPU)")
    return {"device": args.device,
            "dtype": default_compute_dtype(device) if bf16 else torch.float32}


def _echo_record(record: dict) -> None:
    print(json.dumps(record, indent=2, default=str))


# --- data preparation -------------------------------------------------------

def make_splits_cmd(args) -> None:
    """Generate a patient-level, label-stratified train/valid/test split CSV."""
    from .data.splits import SplitRatios, make_splits_from_dirs, split_counts, write_splits

    table = make_splits_from_dirs(list(args.data_dirs), folds=args.folds,
                                  ratios=SplitRatios(args.train, args.valid, args.test),
                                  seed=args.seed)
    path = write_splits(table, args.out_path)
    print(f"Wrote {len(table['patient'])} records x {args.folds} fold(s) to {path}")
    print(json.dumps(split_counts(table), indent=2, default=str))


def summarize_cmd(args) -> None:
    """Aggregate an ablation results JSON into a mean/std Markdown table."""
    from .reporting import load_results, summarize, to_markdown

    summary = summarize(load_results(args.results_json),
                        group_by=[g.strip() for g in args.group_by.split(",")])
    table = to_markdown(summary, metrics=[m.strip() for m in args.metrics.split(",")])
    if args.out_path:
        Path(args.out_path).write_text(table + "\n")
        print(f"Wrote summary table to {args.out_path}")
    print(table)


# --- generative --------------------------------------------------------------

def gen_train(args) -> None:
    """Train a diffusion generator on CinC records."""
    from .data.generative import cinc_generative_dataset
    from .models.registry import get_spec
    from .train.generative import GenBatcher, GenerativeTrainer

    spec = get_spec(args.model_name)
    model = spec.build_model(args.num_classes, seed=args.seed, **_placement(args, args.bf16))
    signal = "ecg" if args.condition_on_ecg else "pcg"
    dataset = cinc_generative_dataset(
        args.data_dir, args.csv_path, "train", fs=spec.sample_rate, mel=spec.mel(signal),
        crop_frames=args.crop_frames or spec.crop_frames, hop_length=spec.hop_length,
        condition_on_ecg=args.condition_on_ecg, segment_dir=args.segment_dir,
        rearrange_cycles=args.rearrange_cycles, prob_contiguous=args.prob_contiguous,
    )
    trainer = GenerativeTrainer(model, spec.loss, args.output_dir, lr=args.lr,
                                sampler=spec.sample, log_dir=args.logdir, seed=args.seed)
    if args.weights:
        trainer.restore(args.weights)
    trainer.train(GenBatcher(dataset, args.batch_size, shuffle=True, seed=args.seed),
                  args.epochs, max_train_batches=args.max_train_batches)
    print(f"Saved generator to {args.output_dir}/weights.pt")


def gen_sample(args) -> None:
    """Generate a synthetic dataset from a trained generator."""
    from .data.generative import cinc_generative_dataset
    from .models.registry import get_spec
    from .train.generate import generate_dataset
    from .train.generative import GenerativeTrainer

    spec = get_spec(args.model_name)
    model = spec.build_model(args.num_classes, seed=args.seed,
                             **_placement(args, bf16=False))
    dataset = cinc_generative_dataset(
        args.data_dir, args.csv_path, "all", fs=spec.sample_rate, mel=spec.mel("pcg"),
        crop_frames=args.crop_frames or spec.crop_frames, hop_length=spec.hop_length,
    )
    trainer = GenerativeTrainer(model, spec.loss, args.output_dir, log=lambda s: None)
    trainer.restore(args.weights)
    kwargs = ({"fast": args.fast} if args.model_name == "diffwave"
              else ({"num_steps": args.num_steps} if args.num_steps else {}))
    path = generate_dataset(model, spec, dataset, args.output_dir, per_item=args.per_item,
                            seed=args.seed, sampler_kwargs=kwargs, batch_size=args.sample_batch)
    print(f"Wrote manifest {path}")


# --- classification ------------------------------------------------------------

def classify_cinc(args) -> None:
    """Run a single-PCG / PCG+ECG classification ablation."""
    from .experiments import cinc

    kwargs = _options(args)
    record = cinc.run(kwargs.pop("data_dir"), kwargs.pop("csv_path"), **kwargs,
                      **_placement(args))
    _echo_record(record)


def classify_vest(args) -> None:
    """Run a multichannel vest classification ablation."""
    from .experiments import multichannel

    kwargs = _options(args)
    data_dir, csv_path = kwargs.pop("data_dir"), kwargs.pop("csv_path")
    chan_list = [int(c) for c in kwargs.pop("channels").split(",")]
    record = multichannel.run(data_dir, csv_path, channels=chan_list, **kwargs,
                              **_placement(args))
    _echo_record(record)


def classify_synthetic(args) -> None:
    """Train single-channel PCG through a synthetic-augmentation schedule."""
    from .experiments import synthetic

    kwargs = _options(args)
    record = synthetic.run(kwargs.pop("schedule_path"), **kwargs, **_placement(args))
    _echo_record(record)


def classify_lsdo(args) -> None:
    """Leave-source-database-out: train on all but one CinC database, test on it."""
    from .experiments import cinc

    kwargs = _options(args)
    databases = {}
    for entry in kwargs.pop("dbs"):
        name, data_dir, csv_path = entry.split(":", 2)
        databases[name] = (data_dir, csv_path)
    record = cinc.run_leave_out_db(databases, kwargs.pop("holdout"), **kwargs,
                                   **_placement(args))
    _echo_record(record)


# --- performance -----------------------------------------------------------------

def bench_cmd(args) -> None:
    """End-to-end throughput benchmark (windows/sec/chip) — see the port's bench.py."""
    from .bench import launched_mesh, run_bench
    from .parallel.mesh import is_main

    device = _placement(args)["device"]
    with launched_mesh(device) as mesh:
        result = run_bench(**_options(args), device=device, mesh=mesh)
        if is_main(mesh):
            print(json.dumps(result))


# --- the parser ------------------------------------------------------------------

def _command(sub, name: str, run) -> argparse.ArgumentParser:
    p = sub.add_parser(name, help=run.__doc__, description=run.__doc__,
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.set_defaults(run=run)
    return p


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="w2vhs-torch", formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="mPCG Wav2Vec on PyTorch + CUDA: synthetic augmentation + heart-sound "
                    "classification.")
    parser.add_argument("--device", default="cuda",
                        help="where the commands that build a model run (cuda or cpu)")
    sub = parser.add_subparsers(dest="command", required=True, metavar="COMMAND")

    p = _command(sub, "make-splits", make_splits_cmd)
    p.add_argument("--data-dir", dest="data_dirs", action="append", required=True,
                   help="directory containing a CinC-style REFERENCE.csv (repeatable)")
    p.add_argument("--out", dest="out_path", required=True,
                   help="output reference/split CSV path")
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--train", type=float, default=0.6)
    p.add_argument("--valid", type=float, default=0.2)
    p.add_argument("--test", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)

    p = _command(sub, "summarize", summarize_cmd)
    p.add_argument("results_json")
    p.add_argument("--group-by", default="run_label", help="comma-separated config fields")
    p.add_argument("--metrics", default="accuracy,uar,sensitivity,specificity,mcc",
                   help="comma-separated metric names to show")
    p.add_argument("--out", dest="out_path", default=None,
                   help="write the Markdown table here")

    p = _command(sub, "gen-train", gen_train)
    p.add_argument("--model", dest="model_name", choices=["diffwave", "wavegrad"],
                   required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--csv", dest="csv_path", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-4)
    _flag(p, "--condition-on-ecg")
    p.add_argument("--segment-dir", default=None,
                   help="cardiac-cycle segmentation dir (enables heart-cycle rearranging)")
    _flag_pair(p, "--rearrange", "--no-rearrange", "rearrange_cycles", True)
    p.add_argument("--prob-contiguous", type=float, default=0.0)
    _flag_pair(p, "--bf16", "--no-bf16", "bf16", True,
               help="bfloat16 compute on the card (float32 parameters)")
    p.add_argument("--crop-frames", type=int, default=None,
                   help="override the conditioning crop (default: generator spec, 96)")
    p.add_argument("--weights", default="", help="checkpoint to resume from")
    p.add_argument("--logdir", default=None, help="scalar/sample log directory")
    p.add_argument("--max-train-batches", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)

    p = _command(sub, "gen-sample", gen_sample)
    p.add_argument("--model", dest="model_name", choices=["diffwave", "wavegrad"],
                   required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--csv", dest="csv_path", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--per-item", type=int, default=1)
    _flag_pair(p, "--fast", "--no-fast", "fast", True, help="fast sampling (DiffWave)")
    p.add_argument("--num-steps", type=int, default=None, help="sub-sampled steps (WaveGrad)")
    p.add_argument("--crop-frames", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-batch", type=int, default=16,
                   help="(item, copy) tasks per batched reverse-diffusion run")

    p = _command(sub, "classify-cinc", classify_cinc)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--csv", dest="csv_path", required=True)
    p.add_argument("--mode", choices=["pcg", "ecg", "pcg_ecg"], default="pcg")
    p.add_argument("--dataset", default="training-a")
    p.add_argument("--fs", type=int, default=4125)
    p.add_argument("--window-s", type=float, default=4.0)
    p.add_argument("--epochs", type=int, default=20)
    _flag_pair(p, "--augment", "--no-augment", "augment", True)
    p.add_argument("--augment-num", type=int, default=15,
                   help="augmented full-record copies per subject (balanced)")
    _flag(p, "--random-init")
    _flag(p, "--reference-train-rnn",
          help="legacy regime: half epochs + augmented validation set")
    _flag(p, "--device-augment",
          help="batched PCG augmentation on the card inside the train step (mono modes)")
    p.add_argument("--wire", choices=["preproc", "raw"], default="preproc",
                   help="raw: ship low-rate raw windows and preprocess on the card "
                        "(8x less transfer; mono pcg mode only)")
    p.add_argument("--fs-wire", type=int, default=2000, help="wire sample rate for --wire raw")
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--results-json", default=None)
    p.add_argument("--logdir", dest="log_dir", default=None)

    p = _command(sub, "classify-vest", classify_vest)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--csv", dest="csv_path", required=True)
    p.add_argument("--channels", default="1,2,3,4,5,6")
    p.add_argument("--fs", type=int, default=4125)
    p.add_argument("--window-s", type=float, default=2.0)
    p.add_argument("--epochs", type=int, default=20)
    _flag_pair(p, "--augment", "--no-augment", "augment", True)
    _flag(p, "--random-init")
    _flag_pair(p, "--lora", "--no-lora", "lora", True)
    _flag(p, "--freeze-encoder")
    _flag_pair(p, "--fit-svm", "--no-svm", "fit_svm", True)
    p.add_argument("--loss", choices=["ce", "contrastive-focal"], default="ce")
    _flag(p, "--device-augment",
          help="run the channel-shared augmentations (noise, wander envelope) batched on "
               "the card; the host keeps only time-stretch/recorded noise")
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--results-json", default=None)
    p.add_argument("--logdir", dest="log_dir", default=None)

    p = _command(sub, "classify-synthetic", classify_synthetic)
    p.add_argument("--schedule", dest="schedule_path", required=True,
                   help="schedule JSON mixing real + generated data")
    p.add_argument("--fs", type=int, default=4125)
    p.add_argument("--window-s", type=float, default=4.0)
    _flag(p, "--random-init")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--results-json", default=None)
    p.add_argument("--logdir", dest="log_dir", default=None)

    p = _command(sub, "classify-lsdo", classify_lsdo)
    p.add_argument("--db", dest="dbs", action="append", required=True,
                   help="repeatable NAME:DATA_DIR:CSV entry, one per CinC database")
    p.add_argument("--holdout", required=True, help="database name held out for testing")
    p.add_argument("--fs", type=int, default=4125)
    p.add_argument("--epochs", type=int, default=20)
    _flag_pair(p, "--augment", "--no-augment", "augment", True)
    _flag(p, "--random-init")
    _flag(p, "--reference-train-rnn")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--results-json", default=None)

    p = _command(sub, "bench", bench_cmd)
    p.add_argument("--batch-size", type=int, default=96)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--window-s", type=float, default=4.0)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--mode", choices=["train", "infer", "preproc"], default="train")
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    run = args.run
    del args.command
    run(args)


if __name__ == "__main__":
    main()
