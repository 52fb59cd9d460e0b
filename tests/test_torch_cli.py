"""The port's command line (`python -m fluctus_tpu_torch.cli`) on the CPU
(`--device cpu`) against the JAX package's (`fluctus_tpu/cli.py`): the
same subcommands, arguments, defaults and choices apart from `--device`;
every subcommand writes its output at 16x16; `render --hdr` writes the
frame the JAX CLI writes at the goldens' tolerance, and `convert` the
JAX CLI's bytes. Each test runs in its own directory, where both CLIs
keep their hierarchy cache (data/hierarchies)."""
import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

from fluctus_tpu.cli import build_parser as jax_parser
from fluctus_tpu.cli import main as jax_main
from fluctus_tpu_torch.cli import build_parser, main
from fluctus_tpu_torch.io.hdr import read_hdr, write_hdr

from golden_common import ATOL, RTOL
from torch_common import REPO

CORNELL = os.path.join(REPO, "assets", "cornell_proxy.obj")
SMALL = ["-x", "16", "-y", "16", "--max-bounces", "2", "--area-light"]


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _actions(parser):
    """{subcommand: {dest: (option strings, default, choices, required,
    nargs, type)}}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.choices,
                            a.required, a.nargs, a.type)
                   for a in p._actions
                   if not isinstance(a, argparse._HelpAction)}
            for name, p in sub.choices.items()}


def test_parser_equals_jax():
    got, want = _actions(build_parser()), _actions(jax_parser())
    assert set(got) == set(want) == {"render", "benchmark", "optimize",
                                     "convert"}
    for name in got:
        if name != "convert":
            dev = got[name].pop("device")
            assert dev[:3] == (("--device",), "cuda", None)
        assert got[name] == want[name], name
    args = build_parser().parse_args(["render", "s.obj"])
    assert args.device == "cuda" and args.backend == "auto"


@pytest.mark.parametrize("extra,out", [
    ([], "plain.png"),
    (["--hdr"], "frame.hdr"),
    (["--denoise", "0.5"], "denoised.png"),
    (["--denoise", "1.0", "--hdr"], "denoised.hdr"),
    (["--progressive", "2", "--export-every", "1"], "prog.png"),
    (["--backend", "packed", "--hdr"], "packed.hdr"),
])
def test_render_writes_its_output(extra, out, capsys):
    main(["render", CORNELL, *SMALL, "-s", "2", "-o", out, *extra,
          "--device", "cpu"])
    assert os.path.getsize(out) > 0
    assert f"wrote {out}" in capsys.readouterr().out
    if out.endswith(".hdr"):
        img = read_hdr(out)
        assert img.shape == (16, 16, 3) and np.isfinite(img).all()
        assert img.mean() > 0.0


def test_render_hdr_equals_the_jax_cli():
    args = ["render", CORNELL, *SMALL, "-s", "2", "--hdr", "--no-sbvh"]
    main([*args, "-o", "port.hdr", "--device", "cpu"])
    jax_main([*args, "-o", "jax.hdr"])
    got, want = read_hdr("port.hdr"), read_hdr("jax.hdr")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_benchmark_writes_csv_and_txt(capsys):
    main(["benchmark", CORNELL, *SMALL, "--duration", "1", "--csv",
          "b.csv", "--txt", "b.txt", "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"integrator": "lockstep"' in out
    rows = open("b.csv").read().splitlines()
    assert rows[0] == "scene;time;primary;extension;shadow;total;samples"
    assert len(rows) >= 2 and os.path.getsize("b.txt") > 0


def test_optimize_takes_two_steps():
    main(["render", CORNELL, *SMALL, "-s", "1", "--hdr", "-o", "t.hdr",
          "--device", "cpu"])
    write_hdr("target.hdr", read_hdr("t.hdr") * 0.5)
    main(["optimize", CORNELL, *SMALL, "--target", "target.hdr",
          "--steps", "2", "--spp", "1", "--minibatch", "64",
          "--out-dir", "opt", "--method", "lockstep", "--device", "cpu"])
    hist = np.load("opt/loss_history.npy")
    assert hist.shape == (2,) and np.isfinite(hist).all()
    assert os.path.exists("opt/opt_kd.npy")


def test_convert_equals_the_jax_cli():
    from fluctus_tpu_torch.fixtures import scene_pbrt
    src = scene_pbrt(CORNELL, ".")
    main(["convert", src, "port.pbf"])
    jax_main(["convert", src, "jax.pbf"])
    with open("port.pbf", "rb") as f, open("jax.pbf", "rb") as g:
        got, want = f.read(), g.read()
    assert len(got) > 0 and got == want


def test_module_runs_from_the_repo_root(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "fluctus_tpu_torch.cli", "render", CORNELL,
         *SMALL, "-s", "1", "-o", str(tmp_path / "m.png"), "--cache-dir",
         str(tmp_path / "h"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "m.png").exists()
