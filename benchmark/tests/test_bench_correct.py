"""`correct` on this machine's CPU at a size a test run holds (16 frames
of 128x160, the cells' head mode): a sound run of the program passes the
cells' limits, and the float8 control and each planted fault of a
labelling cell (half the batch left out; an answer altered where it is
produced; the scene class alone altered, in the cell with a scene head)
fail them. The runs skip the look for a card and drive the
rest of a run: set-up, warm-up, a short window, the check."""

import pytest

from harness import check_label, control, label
from harness.manifest import resolve

SEED = 2 ** 31 + 12345
CELLS = ("emsanet-nyuv2.label-b32", "esanet-nyuv2.label-b32")


def small_cell(name):
    cell = resolve(name)
    cell.traffic.update(batch=16, height=128, width=160, pool=2,
                        warmup_requests=2)
    return cell


def run_cell(cell, wrap=None):
    got = label.run(cell, SEED, 0.2, False, "cpu", wrap=wrap)
    return check_label.judge(got["compared"], cell.checks)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, rows = run_cell(small_cell(name))
    assert ok, rows


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    model, cfg, ds = label.build_program(cell, "cpu")
    weights, _ = label.load_weights(model, cell, SEED, "cpu")
    pool = label.make_pool(cell, SEED, "cpu")
    slots = [{"inputs": p, "host": {},
              "device": control.control_outputs(weights, cell.config, p,
                                                "cpu")} for p in pool]
    values = check_label.numbers(weights, cell.config, slots, "cpu")
    ok, rows = check_label.judge(values, cell.checks)
    assert not ok
    over = {k for k, v in values.items() if v > cell.checks[k]["limit"]}
    assert "semantic_gap" in over
    if "scene" in cell.config["reference"]["tasks"]:
        assert {"scene_gap", "scene_score"} <= over


FAULT_CASES = [(name, fault) for name in CELLS
               for fault in sorted(control.faults_for(resolve(name).config))]


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_planted_fault_is_not_correct(name, fault):
    ok, rows = run_cell(small_cell(name), control.FAULTS[fault])
    assert not ok, rows
    if fault == "scene_altered":
        # only the scene numbers can see it
        failed = {k for k, v, lim in rows if v > lim}
        assert failed and failed <= {"scene_gap", "scene_score"}, rows


def test_scene_is_compared_where_the_cell_has_a_scene_head():
    for name in CELLS:
        cell = resolve(name)
        has = "scene" in cell.config["reference"]["tasks"]
        assert ("scene_gap" in cell.checks) == has
        assert ("scene_score" in cell.checks) == has


def test_judge_needs_every_limit_and_every_number():
    limits = {"_about": "x", "a": {"limit": 1.0}, "b": {"limit": 0}}
    assert check_label.judge({"a": 0.5, "b": 0.0}, limits)[0]
    assert not check_label.judge({"a": 1.5, "b": 0.0}, limits)[0]
    assert not check_label.judge({"a": 0.5}, limits)[0]
    assert not check_label.judge({"a": 0.5, "b": 0.0, "c": 0.0}, limits)[0]
    assert not check_label.judge({"a": 0.5, "b": 0.0}, {})[0]
