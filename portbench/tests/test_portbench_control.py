"""The control: the plain reference in the precision below the cell's
(fp8 for the bf16 NCSN cell; TF32 for the f32 Glow cell, whose matmuls
run with TF32 off) put in the
program's place must read not correct. On the card at the cell's own
widths, frames and traffic over one level (the readings the limits were
set from cover the window's levels on three seeds, ``PERF.md`` §2); on
the CPU at a tiny size, where it must read well above the program."""

import pytest
import torch

from portbench import check, harness, spec, traffic
from portbench.tests.test_portbench_rehearsal import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _inputs(cell, seed, device):
    inp = traffic.make(cell.config, cell.traffic, seed, device)
    return harness.CheckInputs(inp.mixed, inp.x_init, inp.sigmas,
                               inp.generator.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell_on_the_card(cuda, name):
    cell = spec.cell(name)
    arch = spec.arch(cell.config["arch"])
    seed = 2 ** 31 + 4242
    found, _ = check.control_check(arch, cell, seed,
                                   _inputs(cell, seed, cuda), 1, cuda)
    correct, checks = check.judge(found, cell.workload["compare"])
    assert not correct, checks


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program_on_the_cpu(name):
    cell = tiny(spec.cell(name))
    cell = cell._replace(traffic=dict(
        cell.traffic, compute_dtype=spec.cell(name).traffic["compute_dtype"]))
    arch = spec.arch(cell.config["arch"])
    seed, cpu = 2 ** 31 + 99, torch.device("cpu")
    ins = _inputs(cell, seed, cpu)
    ref = check.anneal(arch, cell, seed, ins, list(range(6)), 1,
                       check.Precision("f32"), cpu)
    low, _ = check.control_check(arch, cell, seed, ins, 1, cpu)
    mine, _ = check.control_check(arch, cell, seed, ins, 1, cpu, mode="f32")
    assert mine["x_rms_db"] == 0.0 and ref[0].isfinite().all()
    assert low["x_rms_db"] > 0.0 and low["x_gap_db"] > 0.0
