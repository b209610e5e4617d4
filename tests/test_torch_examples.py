"""The port's examples (slampp_tpu_torch/examples/) through their
``main(argv)`` in-process on the CPU, at tests/test_examples.py's sizes or
smaller, with that file's assertions.  Where the run is deterministic
(simple, online, poly_fitting, geometry, ba_interface), the printed text
equals the JAX package's example's and every printed number is within
1e-8 relative (1e-12 absolute near zero) of it."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from slampp_tpu_torch import examples

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan")


def _port(name, capsys, *args):
    mod = importlib.import_module(f"slampp_tpu_torch.examples.{name}")
    ret = mod.main(["--device", "cpu", *args])
    return ret, capsys.readouterr().out


def _jax(name, capsys):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["simple_example", "online_example", "poly_fitting_example",
                                  "geometry_example", "ba_interface_example"])
def test_deterministic_examples_print_what_jax_prints(name, capsys):
    _, got = _port(name, capsys)
    want = _jax(name, capsys)
    assert NUMBER.split(got) == NUMBER.split(want)
    a = np.array([float(x) for x in NUMBER.findall(got)])
    b = np.array([float(x) for x in NUMBER.findall(want)])
    assert a.shape == b.shape and a.size > 0
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, equal_nan=True)


def test_poly_fitting_uses_chi2_dof(capsys):
    (est, chi2, dof), out = _port("poly_fitting_example", capsys)
    assert dof == 46 and chi2 < 2 * dof
    np.testing.assert_allclose(est, [0.5, -1.2, 0.3, 0.05], atol=0.05)


def test_ba_marginals_example(capsys):
    match, out = _port("ba_marginals_example", capsys)
    assert match and "dense-reference match: True" in out


def test_compact_pose_example(capsys):
    err, out = _port("compact_pose_example", capsys, "--poses", "200")
    ate = float(out.rsplit("keyframe ATE compact-vs-full:", 1)[1].split()[0])
    assert ate < 0.5 and abs(ate - err) < 1e-4


def test_dataassoc_example(capsys):
    (tp, tn), out = _port("dataassoc_example", capsys, "--poses", "150")
    assert "accepted" in out and "rejected" in out
    assert tp >= 25 and tn >= 20


def test_incremental_ba_3dv_example(capsys):
    traces, out = _port("incremental_ba_3dv_example", capsys, "--cams", "5", "--points", "40")
    assert "consistency markers processed" in out
    assert len(traces) >= 3 and all(np.isfinite(traces))


def test_ba_parameter_acra_example(capsys):
    chis, out = _port("ba_parameter_acra_example", capsys)
    assert out.count("obs):") == 3
    for param, c in chis.items():
        assert c[-1] < c[0], param


def test_schur_orderings_study(capsys):
    results, out = _port("schur_orderings_study", capsys, "--poses", "120", "--landmarks", "40")
    assert "vs best" in out
    flops = {}
    for line in out.splitlines():
        m = re.match(r"(chol [a-z-]+|Schur .+?)\s{2,}([0-9.e+]+)\s", line)
        if m:
            flops[m.group(1).strip()] = float(m.group(2))
    # min-degree must beat natural ordering on a loopy landmark graph
    assert flops["chol min-degree"] < flops["chol natural"]
    assert len(results) == 7 and set(flops) <= set(results)


def test_compact_pose_ijrr_study(capsys):
    res, out = _port("compact_pose_ijrr_study", capsys, "--poses", "150")
    comp = int(re.search(r"compact:\s+(\d+) poses", out).group(1))
    full = int(re.search(r"full:\s+(\d+) poses", out).group(1))
    kept = int(re.search(r"loops kept: (\d+)", out).group(1))
    ate = float(re.search(r"keyframe ATE compact-vs-full: ([0-9.]+)", out).group(1))
    assert comp < full          # poses actually pruned
    assert kept > 0             # some loops accepted through the gain gate
    assert ate < 1.0            # compact trajectory tracks the full one
    assert (res["compact"], res["full"], res["loops_kept"]) == (comp, full, kept)


def test_examples_raise_without_a_card():
    """Every example takes --device: the card by default, which raises
    where there is none."""
    if torch.cuda.is_available():
        assert examples.parse_args([], "example").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            examples.parse_args([], "example")
    assert examples.parse_args(["--device", "cpu"], "example").device.type == "cpu"


def test_host_only_examples_need_no_card(capsys):
    """The NumPy-only examples run with the default --device, card or not."""
    assert examples.parse_args([], "example", host_only=True).device.type == "cuda"
    mod = importlib.import_module("slampp_tpu_torch.examples.geometry_example")
    mod.main([])
    assert "P3P" in capsys.readouterr().out
