"""Cells, configurations, traffic mixes and metrics are found by name."""
import copy
import dataclasses
import re

import pytest

from portbench import harness, loadgen

CONTRACT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                 "end_to_end", "per_layer"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_has_the_contract_keys(bench):
    assert set(bench) == CONTRACT_KEYS
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]


def test_every_name_is_a_contract_name(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", ["server-moon2048-c2x28",
                                  "lib-moon8192-solve"])
def test_cell_finds_its_configuration_and_mix(bench, cell):
    c = harness.find_cell(bench, cell)
    assert c.config["name"] == c.spec["config"]
    assert c.config["reduced"] == []
    assert set(c.traffic) == set(loadgen.KEYS)
    for key in loadgen.KEYS:
        assert float(c.traffic[key]) > 0
    assert set(c.config["limits"]) == set(c.reference.NUMBERS)
    assert c.entry.__name__ == f"portbench.entries.{c.config['entry']}"
    assert c.data.__name__ == "portbench.data.moon"


def test_unknown_cell_is_refused(bench):
    with pytest.raises(KeyError):
        harness.find_cell(bench, "no-such-cell")


@pytest.mark.parametrize("cell", ["server-moon2048-c2x28",
                                  "lib-moon8192-solve"])
def test_configuration_is_a_solver_the_program_takes(bench, cell):
    from repro_torch.api.solvers import get_solver
    c = harness.find_cell(bench, cell)
    cls = get_solver(c.config["solver"]["name"])
    sv = cls(**c.settings)
    assert sv.s == 16 * int(c.traffic["n"])
    assert dataclasses.asdict(cls.default_config(sv.s // 16)) \
        == dataclasses.asdict(sv)


@pytest.mark.parametrize("where,key", [
    (None, "tolerance"), ("problem", "noise"), ("server", "threads"),
    ("solver", "warm_start")])
def test_a_key_that_nothing_reads_is_refused(bench, where, key):
    c = harness.find_cell(bench, "server-moon2048-c2x28")
    c.config = copy.deepcopy(c.config)
    (c.config if where is None else c.config[where])[key] = 1
    with pytest.raises(ValueError, match=key):
        harness.check_cell(c)


@pytest.mark.parametrize("change", [
    {"batch": 8}, {"collection": 1}, {"collection": 40}])
def test_a_mix_the_generator_cannot_send_is_refused(bench, change):
    c = harness.find_cell(bench, "server-moon2048-c2x28")
    c.traffic = dict(c.traffic, **change)
    with pytest.raises(ValueError):
        harness.check_cell(c)


@pytest.mark.parametrize("change", [
    {"dtype": "float64"}, {"reference": "no_such_reference"},
    {"limits": {"value_rel": 1e-5}}])
def test_a_configuration_the_reference_cannot_judge_is_refused(bench,
                                                              change):
    c = harness.find_cell(bench, "lib-moon8192-solve")
    c.config = dict(copy.deepcopy(c.config), **change)
    with pytest.raises((ValueError, NotImplementedError, ImportError)):
        harness.check_cell(c)


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read), m["name"]


def test_metrics_of_a_cell(bench):
    e2e = [m["name"] for m in
           harness.metric_specs(bench, "lib-moon8192-solve", False)]
    assert e2e == ["requests_per_s", "peak_mem_gib", "setup_s"]
    served = [m["name"] for m in
              harness.metric_specs(bench, "server-moon2048-c2x28", True)]
    assert "serve.flush_s" in served and "solve.dispatch_s" not in served
    for cell in ("lib-moon8192-solve", "server-moon2048-c2x28"):
        moved = {m["moves"] for m in harness.metric_specs(bench, cell, True)}
        reported = {m["name"] for m in harness.metric_specs(bench, cell,
                                                            False)}
        assert moved <= reported
