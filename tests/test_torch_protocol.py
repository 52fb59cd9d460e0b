"""The reference-protocol sweep (fluctus_tpu_torch/scripts/run_protocol.py)
against the JAX package's scripts/run_protocol.py: the same scenes, the
reference CSV schema, the summary's keys, the averaged .txt report and
the verdict on the openness probe's pick, run on the CPU on the cornell
at 16x16 for 0.2 s an integrator."""
import ast
import importlib.util
import json
import os
import sys
import types

import pytest
import torch

from fluctus_tpu.render import benchmark as jax_benchmark
from fluctus_tpu_torch.render import benchmark
from fluctus_tpu_torch.scripts import run_protocol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "run_protocol.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops; one thread each keeps the test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_run_protocol",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_summary_keys():
    """The keys of the dict literal the JAX script appends to its
    summary."""
    tree = ast.parse(open(JAX_SCRIPT).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "summary"):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no summary.append in the JAX script")


def test_scenes_are_the_jax_scripts():
    """The same scenes in the same order, with the same env maps, lights
    and bounces, the files under the same names."""
    jax = _jax_script()
    assert run_protocol.SIZE == 1024
    # the reference assets are looked for inside the checkout only
    assert run_protocol.ASSETS == os.path.join(REPO, "reference", "assets")
    assert len(run_protocol.SCENES) == len(jax.SCENES)
    for mine, theirs in zip(run_protocol.SCENES, jax.SCENES):
        assert mine[0] == theirs[0] and mine[3:] == theirs[3:]
        for a, b in ((mine[1], theirs[1]), (mine[2], theirs[2])):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.split("assets/")[-1] == b.split("assets/")[-1]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """One sweep on the CPU: the cornell at 16x16, 2 bounces, 0.2 s an
    integrator, and a scene whose file is absent."""
    tmp = tmp_path_factory.mktemp("protocol")
    mp = pytest.MonkeyPatch()
    mp.chdir(tmp)
    mp.setattr(run_protocol, "SIZE", 16)
    mp.setattr(run_protocol, "SCENES", [
        ("absent", str(tmp / "absent.obj"), None, False, 4),
        ("cornell", os.path.join(REPO, "assets", "cornell_proxy.obj"), None,
         True, 2)])
    seen = []
    write = benchmark.write_txt_report
    mp.setattr(benchmark, "write_txt_report",
               lambda path, results: seen.append(results) or write(path,
                                                                   results))
    try:
        summary = run_protocol.main(["--duration", "0.2", "--device",
                                     "cpu"])
    finally:
        mp.undo()
    return tmp, summary, seen[0]


def test_sweep_writes_the_reference_csvs(sweep):
    tmp, summary, _ = sweep
    for integ in ("lockstep", "stream"):
        lines = (tmp / "out" / f"protocol_cornell_{integ}.csv").read_text() \
            .splitlines()
        assert lines[0] == jax_benchmark.CSV_HEADER == benchmark.CSV_HEADER
        assert len(lines) >= 2
        cells = lines[1].split(";")
        assert cells[0] == "cornell" and len(cells) == 7
        assert all(float(c) >= 0 for c in cells[1:])
    assert not (tmp / "out" / "protocol_absent_lockstep.csv").exists()


def test_summary_has_the_jax_keys(sweep):
    tmp, summary, _ = sweep
    on_disk = json.loads((tmp / "out" / "protocol_summary.json")
                         .read_text())
    assert on_disk == summary and len(summary) == 1
    assert list(summary[0]) == _jax_summary_keys()
    row = summary[0]
    assert row["scene"] == "cornell"
    assert row["auto"] == "lockstep"        # a CPU session's pick
    assert row["winner"] in ("lockstep", "stream")
    assert row["lockstep_msamples_s"] >= 0 and row["stream_msamples_s"] >= 0


def test_txt_report_equals_jax(sweep, tmp_path):
    tmp, _, results = sweep
    assert [r["scene"] for r in results] == ["cornell [lockstep]",
                                             "cornell [stream]"]
    assert all(r["samples_mrays_s"] > 0 for r in results)
    jax_benchmark.write_txt_report(str(tmp_path / "jax.txt"), results)
    assert (tmp / "out" / "protocol_summary.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()


def _jax_verdict(lock, stream, auto, tmp_path, monkeypatch, capsys):
    """(winner, tie, auto correct) as the JAX script decides them: its
    main on one scene whose session, probe and benchmarks are stubbed, the
    probe picking `auto` and the integrators reporting `lock` and
    `stream` samples/s."""
    jax = _jax_script()
    scene = tmp_path / "stub.obj"
    scene.write_text("")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["run_protocol.py"])
    monkeypatch.setattr(jax, "SCENES", [("stub", str(scene), None, True, 2)])
    monkeypatch.setattr(jax, "driver", types.SimpleNamespace(
        create_session=lambda *a, **k: None,
        choose_integrator=lambda sess: auto))

    def rate(r):
        return lambda sess, duration_s, scene_name, csv_path: dict(
            total_mrays_s=r, samples_mrays_s=r, samples_per_pixel=1.0)
    monkeypatch.setattr(jax, "run_benchmark", rate(lock))
    monkeypatch.setattr(jax, "run_benchmark_stream", rate(stream))
    monkeypatch.setattr(jax, "write_txt_report", lambda path, results: None)
    capsys.readouterr()
    jax.main()
    said = capsys.readouterr().out
    row = json.loads((tmp_path / "out" / "protocol_summary.json")
                     .read_text())[0]
    return row["winner"], "(tie)" in said, row["auto_correct"]


@pytest.mark.parametrize("lock,stream,auto,want", [
    (1.00, 0.50, "lockstep", ("lockstep", False, True)),
    (1.00, 0.50, "stream", ("lockstep", False, False)),
    (0.50, 1.00, "stream", ("stream", False, True)),
    (0.50, 1.00, "lockstep", ("stream", False, False)),
    (1.00, 0.96, "stream", ("lockstep", True, True)),
    (1.00, 0.9501, "stream", ("lockstep", True, True)),
    (1.00, 0.9499, "stream", ("lockstep", False, False)),
])
def test_verdict_tie_and_miss(lock, stream, auto, want, tmp_path,
                              monkeypatch, capsys):
    """The winner by samples/s, a tie within 5 % (either pick right),
    and MISS for the wrong pick outside it: the port's verdict equals the
    JAX script's own on the same rates."""
    rows = {"lockstep": {"samples_mrays_s": lock},
            "stream": {"samples_mrays_s": stream}}
    assert run_protocol.verdict(rows, auto) == want
    assert _jax_verdict(lock, stream, auto, tmp_path, monkeypatch,
                        capsys) == want
