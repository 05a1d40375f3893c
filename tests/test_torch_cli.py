"""The port's command line (argparse) against the JAX package's (click), on the CPU.

* The surface: for each of the eight commands, the argparse parser's options (names, dests,
  types, choices, defaults, required, repeatable, flag pairs) equal the click command's
  ``params``, and both parse the same argv to the same values; ``--help`` lists the eight.
* ``make-splits`` writes the JAX command's CSV byte for byte (1, 2 and 5 folds, unequal
  ratios, odd class sizes, two data directories) and echoes the same counts once both are
  parsed as JSON; ``make_splits`` with a ``patient_fn`` writes the JAX table's CSV.
* ``summarize`` prints the JAX command's table and writes the same file.
* The four ``classify-*`` commands hand the port's runners what the JAX CLI hands the JAX
  runners (both replaced by recorders), plus ``device``/``dtype``; ``--device cuda`` without
  a card is an error.
* ``gen-train`` -> ``gen-sample`` round trip on the CPU at full width (DiffWave), cropped to 2
  conditioning frames, one batch, in one torch thread.
"""

import json
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner

from wav2vec_heart_sounds_tpu import cli as jax_cli
from wav2vec_heart_sounds_tpu.data import splits as jax_splits
from wav2vec_heart_sounds_tpu.experiments import cinc as jax_cinc
from wav2vec_heart_sounds_tpu.experiments import multichannel as jax_multichannel
from wav2vec_heart_sounds_tpu.experiments import synthetic as jax_synthetic
from wav2vec_heart_sounds_tpu_torch import cli
from wav2vec_heart_sounds_tpu_torch.data import generated, splits, wfdb_io
from wav2vec_heart_sounds_tpu_torch.config import WindowSpec
from wav2vec_heart_sounds_tpu_torch.experiments import cinc, multichannel, synthetic
from torch_vocoder_pairs import one_torch_thread  # noqa: F401

COMMANDS = ("make-splits", "summarize", "gen-train", "gen-sample", "classify-cinc",
            "classify-vest", "classify-synthetic", "classify-lsdo")


def _click_options(command) -> dict:
    """name -> (option strings, the pair's off switch, kind, choices, default, required,
    repeatable) of a click command."""
    out = {}
    for p in command.params:
        default = None if type(p.default).__name__ == "Sentinel" else p.default
        if getattr(p, "is_flag", False):
            kind = "pair" if p.secondary_opts else "flag"
        else:
            kind = type(p.type).__name__
        choices = tuple(p.type.choices) if hasattr(p.type, "choices") else None
        out[p.name] = (tuple(p.opts), tuple(getattr(p, "secondary_opts", ())), kind, choices,
                       default, p.required, p.multiple)
    return out


_KINDS = {int: "IntParamType", float: "FloatParamType", None: "StringParamType"}


def _argparse_options(parser) -> dict:
    """The same for an argparse subparser."""
    out, pairs = {}, {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        default = parser.get_default(a.dest)
        if a.const is True or a.const is False:           # store_true / store_false
            pairs.setdefault(a.dest, {})[a.const] = tuple(a.option_strings)
            continue
        opts = tuple(a.option_strings) or (a.dest,)
        kind = "Choice" if a.choices else _KINDS[a.type]
        required = a.required or not a.option_strings
        out[a.dest] = (opts, (), kind, tuple(a.choices) if a.choices else None, default,
                       required, type(a).__name__ == "_AppendAction")
    for dest, sides in pairs.items():
        default = parser.get_default(dest)
        kind = "pair" if False in sides else "flag"
        out[dest] = (sides[True], sides.get(False, ()), kind, None, default, False, False)
    return out


def _subparsers() -> dict:
    parser = cli.build_parser()
    (action,) = [a for a in parser._actions if a.dest == "command"]
    return action.choices


@pytest.mark.parametrize("name", COMMANDS)
def test_options_equal_the_click_commands(name):
    ours = _argparse_options(_subparsers()[name])
    theirs = _click_options(jax_cli.cli.commands[name])
    assert ours == theirs


# Each command's required options, then every option given a non-default value.
ARGV = {
    "make-splits": (["--data-dir", "a", "--out", "o.csv"],
                    ["--data-dir", "a", "--data-dir", "b", "--out", "o.csv", "--folds", "3",
                     "--train", "0.5", "--valid", "0.3", "--test", "0.2", "--seed", "7"]),
    "summarize": (["r.json"], ["r.json", "--group-by", "a,b", "--metrics", "mcc",
                               "--out", "t.md"]),
    "gen-train": (["--model", "diffwave", "--data-dir", "d", "--csv", "c", "--output-dir", "o"],
                  ["--model", "wavegrad", "--data-dir", "d", "--csv", "c", "--output-dir", "o",
                   "--epochs", "3", "--num-classes", "3", "--batch-size", "4", "--lr", "0.1",
                   "--condition-on-ecg", "--segment-dir", "s", "--no-rearrange",
                   "--prob-contiguous", "0.5", "--no-bf16", "--crop-frames", "4",
                   "--weights", "w", "--logdir", "l", "--max-train-batches", "2",
                   "--seed", "5"]),
    "gen-sample": (["--model", "diffwave", "--weights", "w", "--data-dir", "d", "--csv", "c",
                    "--output-dir", "o"],
                   ["--model", "wavegrad", "--weights", "w", "--data-dir", "d", "--csv", "c",
                    "--output-dir", "o", "--num-classes", "3", "--per-item", "2", "--no-fast",
                    "--num-steps", "6", "--crop-frames", "2", "--seed", "1",
                    "--sample-batch", "4"]),
    "classify-cinc": (["--data-dir", "d", "--csv", "c"],
                      ["--data-dir", "d", "--csv", "c", "--mode", "pcg_ecg", "--dataset", "x",
                       "--fs", "16000", "--window-s", "2.5", "--epochs", "2", "--no-augment",
                       "--augment-num", "3", "--random-init", "--reference-train-rnn",
                       "--device-augment", "--wire", "raw", "--fs-wire", "1000", "--fold", "2",
                       "--max-batches", "2", "--results-json", "r", "--logdir", "l"]),
    "classify-vest": (["--data-dir", "d", "--csv", "c"],
                      ["--data-dir", "d", "--csv", "c", "--channels", "1,3", "--fs", "2000",
                       "--window-s", "1.5", "--epochs", "2", "--no-augment", "--random-init",
                       "--no-lora", "--freeze-encoder", "--no-svm", "--loss",
                       "contrastive-focal", "--device-augment", "--fold", "3",
                       "--max-batches", "1", "--results-json", "r", "--logdir", "l"]),
    "classify-synthetic": (["--schedule", "s.json"],
                           ["--schedule", "s.json", "--fs", "2000", "--window-s", "2.0",
                            "--random-init", "--max-batches", "2", "--results-json", "r",
                            "--logdir", "l"]),
    "classify-lsdo": (["--db", "a:d1:c1", "--db", "b:d2:c2", "--holdout", "b"],
                      ["--db", "a:d1:c1", "--db", "b:d2:c2", "--holdout", "a", "--fs", "2000",
                       "--epochs", "2", "--no-augment", "--random-init",
                       "--reference-train-rnn", "--max-batches", "1", "--results-json", "r"]),
}


@pytest.mark.parametrize("name", COMMANDS)
@pytest.mark.parametrize("which", [0, 1], ids=["required", "every-option"])
def test_parses_argv_as_click(name, which):
    argv = ARGV[name][which]
    theirs = jax_cli.cli.commands[name].make_context(name, list(argv)).params
    ours = vars(cli.build_parser().parse_args(["--device", "cpu", name, *argv]))
    for key in ("run", "command", "device"):
        ours.pop(key)
    theirs = {k: list(v) if isinstance(v, tuple) else v for k, v in theirs.items()}
    assert ours == theirs


def test_help_lists_the_eight_commands(capsys):
    with pytest.raises(SystemExit) as stop:
        cli.main(["--help"])
    assert stop.value.code == 0
    text = capsys.readouterr().out
    assert all(name in text for name in COMMANDS) and "bench" not in text
    assert "--device" in text


def _reference_dir(root: Path, n: int, seed: int, abnormal_every: int) -> str:
    root.mkdir()
    rng = np.random.default_rng(seed)
    names = [f"r{seed}_{i:03d}" for i in rng.permutation(n)]      # unsorted on disk
    (root / "REFERENCE.csv").write_text("".join(
        f"{name},{1 if i % abnormal_every == 0 else -1}\n" for i, name in enumerate(names)))
    return str(root)


@pytest.mark.parametrize("counts,folds,ratios", [
    ((30,), 1, None), ((31,), 2, ("0.5", "0.3", "0.2")), ((17, 12), 5, ("0.7", "0.1", "0.2"))],
    ids=["1-fold", "2-fold-unequal", "5-fold-two-dirs"])
def test_make_splits_writes_the_jax_csv(tmp_path, capsys, counts, folds, ratios):
    argv = []
    for i, n in enumerate(counts):
        argv += ["--data-dir", _reference_dir(tmp_path / f"db{i}", n, seed=i,
                                              abnormal_every=3 + i)]
    if ratios:
        argv += ["--train", ratios[0], "--valid", ratios[1], "--test", ratios[2]]
    argv += ["--folds", str(folds), "--seed", "11"]
    theirs = CliRunner().invoke(jax_cli.cli, ["make-splits", *argv, "--out",
                                              str(tmp_path / "jax.csv")])
    assert theirs.exit_code == 0, theirs.output
    cli.main(["make-splits", *argv, "--out", str(tmp_path / "port.csv")])
    ours = capsys.readouterr().out
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    head, body = ours.split("\n", 1)
    their_head, their_body = theirs.output.split("\n", 1)
    assert head == their_head.replace("jax.csv", "port.csv")
    assert json.loads(body) == json.loads(their_body)


def test_make_splits_with_a_patient_fn_writes_the_jax_table(tmp_path):
    rng = np.random.default_rng(3)
    labels = {f"p{p:02d}_r{r}": int(rng.integers(0, 2)) * 2 - 1
              for p in range(13) for r in range(int(rng.integers(1, 4)))}
    kw = dict(folds=3, ratios=splits.SplitRatios(0.5, 0.25, 0.25), seed=5,
              patient_fn=lambda record: record.split("_")[0])
    jax_kw = dict(kw, ratios=jax_splits.SplitRatios(0.5, 0.25, 0.25))
    splits.write_splits(splits.make_splits(labels, **kw), tmp_path / "port.csv")
    jax_splits.write_splits(jax_splits.make_splits(labels, **jax_kw), tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_summarize_prints_the_jax_table(tmp_path, capsys):
    rng = np.random.default_rng(2)
    records = [{"run_label": label, "fs": 4125,
                "fragment": {m: float(rng.random()) for m in ("accuracy", "uar", "mcc")},
                "patient": {m: float(rng.random()) for m in ("accuracy", "mcc", "f1")},
                "mlp": {"patient": {"uar": float(rng.random())}}}
               for label in ("a", "b", "a", "c", "a")]
    path = tmp_path / "results.json"
    path.write_text(json.dumps(records))
    args = [str(path), "--group-by", "run_label,fs", "--metrics", "accuracy,uar,mcc"]
    theirs = CliRunner().invoke(jax_cli.cli, ["summarize", *args, "--out",
                                              str(tmp_path / "jax.md")])
    assert theirs.exit_code == 0, theirs.output
    cli.main(["summarize", *args, "--out", str(tmp_path / "port.md")])
    assert capsys.readouterr().out == theirs.output.replace("jax.md", "port.md")
    assert (tmp_path / "port.md").read_text() == (tmp_path / "jax.md").read_text()


RUNNERS = {  # command -> (the JAX module and function, the port's)
    "classify-cinc": ((jax_cinc, "run"), (cinc, "run")),
    "classify-lsdo": ((jax_cinc, "run_leave_out_db"), (cinc, "run_leave_out_db")),
    "classify-vest": ((jax_multichannel, "run"), (multichannel, "run")),
    "classify-synthetic": ((jax_synthetic, "run"), (synthetic, "run")),
}


@pytest.mark.parametrize("name", list(RUNNERS))
@pytest.mark.parametrize("which", [0, 1], ids=["required", "every-option"])
def test_classify_commands_call_the_runners_as_the_jax_cli(monkeypatch, capsys, name, which):
    calls = {}
    for side, (module, fn) in zip(("jax", "port"), RUNNERS[name]):
        def record(*args, _side=side, **kwargs):
            calls[_side] = (args, kwargs)
            return {"loss": 0.5, "side": "same"}
        monkeypatch.setattr(module, fn, record)
    argv = [name, *ARGV[name][which]]
    theirs = CliRunner().invoke(jax_cli.cli, argv)
    assert theirs.exit_code == 0, theirs.output
    cli.main(["--device", "cpu", *argv])
    assert json.loads(capsys.readouterr().out) == json.loads(theirs.output)
    args, kwargs = calls["port"]
    assert args == calls["jax"][0]
    assert kwargs == {**calls["jax"][1], "device": "cpu", "dtype": torch.float32}


def test_cuda_without_a_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cinc, "run", lambda *a, **k: pytest.fail("the runner ran"))
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        cli.main(["classify-cinc", *ARGV["classify-cinc"][0]])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    args = types.SimpleNamespace(device="cuda")
    assert cli._placement(args) == {"device": "cuda", "dtype": torch.bfloat16}
    assert cli._placement(args, bf16=False)["dtype"] == torch.float32


def test_gen_train_then_gen_sample_on_the_cpu(tmp_path, capsys):
    data = tmp_path / "db"
    data.mkdir()
    rng = np.random.default_rng(0)
    fs, rows = 2000, []
    for i, label in enumerate([1, -1]):
        t = np.arange(2 * fs) / fs
        pcg = np.sin(2 * np.pi * 80 * t) + 0.05 * rng.normal(size=t.size)
        wfdb_io.write_record(str(data / f"g{i}"), pcg, fs, sig_names=["PCG"])
        rows.append({"patient": f"g{i}", "abnormality": label, "split": "train"})
    pd.DataFrame(rows).to_csv(data / "split.csv", index=False)
    model_dir, out = tmp_path / "model", tmp_path / "generated"
    common = ["--model", "diffwave", "--data-dir", str(data), "--csv", str(data / "split.csv"),
              "--crop-frames", "2"]
    cli.main(["--device", "cpu", "gen-train", *common, "--output-dir", str(model_dir),
              "--epochs", "1", "--batch-size", "2", "--max-train-batches", "1"])
    assert capsys.readouterr().out.endswith(f"Saved generator to {model_dir}/weights.pt\n")
    saved = torch.load(model_dir / "weights.pt", weights_only=True)
    assert saved["step"] == 1
    assert all(v.dtype == torch.float32 for v in saved["model"].values())
    cli.main(["--device", "cpu", "gen-sample", *common, "--weights",
              str(model_dir / "weights.pt"), "--output-dir", str(out), "--per-item", "1"])
    assert capsys.readouterr().out == f"Wrote manifest {out / 'REFERENCE.csv'}\n"
    frags = generated.generated_fragments(str(out), fs_out=4000,
                                          window=WindowSpec(window_s=0.1, overlap_s=0.02,
                                                            start_pad_s=0.0))
    assert len(frags) >= 2
