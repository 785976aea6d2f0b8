"""The port's CLI launcher (`python -m repro_torch.launch.fl_train`)
against `repro.launch.fl_train`: the same arguments and defaults build the
reference's `FLExperiment` field for field, and a tiny FedBuff run through
`main([..., "--device", "cpu"])` prints a summary and writes a JSONL
stream (one line per evaluation) and an `--out` file with the integers of
the reference CLI's run of the same arguments."""
import contextlib
import io
import json
import sys

import pytest

import repro.launch.fl_train as RL
import repro_torch.launch.fl_train as TL


class _Built(Exception):
    pass


def _reference_experiment(monkeypatch, argv):
    """The experiment the reference CLI builds from `argv` (its own parser
    and defaults), caught at `Federation.from_experiment`."""
    seen = {}

    class Stub:
        @staticmethod
        def from_experiment(exp):
            seen["exp"] = exp
            raise _Built

    monkeypatch.setattr(RL, "Federation", Stub)
    monkeypatch.setattr(sys, "argv", ["fl_train"] + list(argv))
    with pytest.raises(_Built):
        RL.main()
    return seen["exp"]


@pytest.mark.parametrize("argv", [
    [],
    ["--scheduler", "fedbuff", "--M", "4", "--days", "7",
     "--setting", "iid", "--seed", "3"],
    ["--scheduler", "fedspace", "--local-steps", "8", "--client-lr", "0.5",
     "--satellites", "40", "--num-train", "1000", "--target-acc", "0.3"],
    ["--scheduler", "async", "--model", "transformer", "--days", "0.5"],
])
def test_build_experiment_equals_the_reference(monkeypatch, argv):
    ref = _reference_experiment(monkeypatch, argv)
    args = TL.parser().parse_args(argv)
    assert args.device is None              # the card by default
    got = TL.build_experiment(args)
    assert got.describe() == ref.describe()
    if not argv:
        assert (got.constellation.num_satellites, got.constellation.days,
                got.dataset.num_train, got.train.max_windows,
                got.train.repeat_connectivity) == (191, 5.0, 9600, 960, 0)


TINY = ["--scheduler", "fedbuff", "--satellites", "8", "--days", "0.5",
        "--num-train", "400", "--M", "2", "--local-steps", "2",
        "--target-acc", "0.99"]


def test_main_on_the_cpu_writes_the_reference_integers(monkeypatch,
                                                       tmp_path):
    jsonl, out = tmp_path / "m.jsonl", tmp_path / "out.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = TL.main(TINY + ["--metrics-jsonl", str(jsonl),
                                  "--out", str(out), "--device", "cpu"])
    text = buf.getvalue()
    assert "[fedbuff] day" in text          # the progress lines
    printed = json.loads(text[text.index("\n{") + 1:])
    assert printed == summary
    events = [json.loads(x) for x in open(jsonl)]
    evals = [e for e in events if e["event"] == "eval"]
    saved = json.load(open(out))
    assert saved["summary"] == summary
    assert len(evals) == len(saved["eval_windows"]) == len(
        saved["accuracy"]) > 0
    assert [e["event"] for e in events] == \
        ["run_begin"] + ["eval"] * len(evals) + ["run_end"]
    # the reference CLI on the same arguments
    rjsonl = tmp_path / "r.jsonl"
    monkeypatch.setattr(sys, "argv", ["fl_train"] + TINY
                        + ["--metrics-jsonl", str(rjsonl)])
    rbuf = io.StringIO()
    with contextlib.redirect_stdout(rbuf):
        RL.main()
    rtext = rbuf.getvalue()
    ref = json.loads(rtext[rtext.index("\n{") + 1:])
    for key in ("scheme", "global_updates", "aggregated_gradients",
                "idle_connections", "total_connections", "staleness_hist",
                "time_to_target_days", "replan_stats"):
        assert summary[key] == ref[key], key
    assert len([x for x in open(rjsonl)]) == len(events)
