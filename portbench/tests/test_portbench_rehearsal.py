"""``run.py`` rehearsed on the CPU at a tiny size on the plain paths (the
port's eager anneal, the Winograd kernels' plain version), skipping the
look for a card: down to the last line's keys, and ``correct`` false when
the timed path is broken underneath."""

import json

import pytest
import torch

from portbench import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2 ** 31 + 77


def tiny(cell):
    """The cell at a size a test holds, in float32 (the limits hold the
    cell's bf16 or f32 program at full size; a float32 rehearsal sits far
    under them, a broken path far over)."""
    cfg = dict(cell.config, num_classes=2, data_shape=[16, 16, 1], T=3)
    if cfg["arch"] == "ncsn_v1":
        cfg.update(n_filters=4)
    else:
        cfg.update(L=3, K=2, n_filters=8)
    traffic = dict(cell.traffic, frames=6, compute_dtype="float32")
    return cell._replace(config=cfg, traffic=traffic)


def _run(capsys, name, trace=0, seconds=0.01):
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  cell_override=tiny)
    out, err = capsys.readouterr()
    return rc, out.strip().splitlines(), err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_prints_the_result_line(capsys, name, trace):
    rc, out, err = _run(capsys, name, trace)
    assert rc == 0, err
    line = json.loads(out[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] is True, line
    assert line["attempted"] == 3 and line["failed"] == 0
    assert line["build"] == {"built": False, "seconds": 0.0}   # no card
    if trace == 0:
        assert set(line["metrics"]) == {"sep_step_ms", "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        # nothing to read on the CPU: no trace, no peaks, no graph
        assert line["metrics"] == {}
    cell = spec.cell(name)
    assert set(line["checks"]) == set(cell.workload["compare"])
    for k, c in line["checks"].items():
        assert f"check {k} {c['value']!r} limit {c['limit']!r}" in err
    assert err.rstrip().splitlines()[-1].startswith("check ")


def test_window_holds_whole_levels(capsys):
    rc, out, err = _run(capsys, CELLS[0], seconds=1e6)
    line = json.loads(out[-1])
    assert rc == 0 and line["attempted"] == 2 * 3      # every level


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def _break(monkeypatch, how, one_db):
    """Break the timed path underneath: wrap each level's step body."""
    from audiosourcesep_tpu_torch.separation import graphs
    anneal = graphs.anneal

    def broken(make_step, x, *a, **k):
        def make(level):
            body = make_step(level)

            def step(x, noise):
                before = x.clone()
                if how != "unchanged":
                    body(x, noise)
                if how == "half_batch":
                    n = x.shape[1] // 2
                    x[:, n:] = before[:, n:] + (x - before)[:, :n].mean(
                        dim=1, keepdim=True)
                elif how == "altered":
                    x[0] += 2 * one_db
            return step
        return anneal(make, x, *a, **k)

    monkeypatch.setattr(graphs, "anneal", broken)


@pytest.mark.parametrize("how", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_reads_not_correct(capsys, monkeypatch, name, how):
    """A step that returns its state unchanged; half the batch left out
    (its update the mean of the other half's); an answer altered where it
    is produced (one source moved by 2 dB a step). One card: no exchange
    between chips to leave out."""
    _break(monkeypatch, how, 1.0 / spec.cell(name).config["db_per_unit"])
    rc, out, err = _run(capsys, name)
    line = json.loads(out[-1])
    assert rc == 0 and line["correct"] is False, line
