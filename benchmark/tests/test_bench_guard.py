"""A run refuses to start without a card and prints no result, also in a
directory that holds only the benchmark; the import check compares whole
top-level names; the inputs are the same for the same (seed, step)."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _paths import ROOT
from benchmark.harness import guard, spec as specs
from benchmark.harness.seeds import WARM

ARGS = ["--workload", "r1cs-2p14", "--seed", "3000000019", "--seconds", "1", "--trace", "0"]


def _no_result(proc) -> bool:
    for line in proc.stdout.splitlines():
        try:
            json.loads(line)
            return False
        except ValueError:
            pass
    return True


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")


def test_refuses_without_a_card(no_card):
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), *ARGS],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0 and _no_result(proc)
    assert "CUDA" in proc.stderr


def test_refuses_in_a_bare_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], capture_output=True,
                          text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and _no_result(proc)


def test_import_check_compares_whole_top_level_names():
    names = ["zinc_tpu_torch", "zinc_tpu_torch.zinc", "jax_like", "jaxlib.xla", "zinc_tpu.ops",
             "flaxen", "flax"]
    assert guard.forbidden_modules(names) == ["flax", "jaxlib.xla", "zinc_tpu.ops"]


def test_benchmark_loads_no_jax():
    for cell in ("r1cs-2p14", "sumcheck-2p20"):
        spec = specs.load(cell)
        specs.module("drivers", spec.config["driver"])
        for m in spec.end_to_end + spec.per_layer:
            specs.module("metrics", m["name"])
    __import__("benchmark.control")
    __import__("benchmark.run")
    assert guard.forbidden_modules() == []


def _r1cs(seed):
    spec = specs.load("r1cs-2p14")
    cell = specs.module("drivers", "zinc_r1cs").Cell(spec.config, dict(spec.traffic, log_n=8),
                                                     seed, "cpu")
    return spec, cell


def test_r1cs_instances_are_fixed_by_seed_and_step_and_satisfied():
    spec, a = _r1cs(3000000019)
    _, b = _r1cs(3000000019)
    assert np.array_equal(a.z(4), b.z(4)) and not np.array_equal(a.z(4), a.z(5))
    assert not np.array_equal(a.z(4), _r1cs(3000000020)[1].z(4))
    z = a.z(4)
    assert z[1] == 1 and np.abs(z).max() < 1 << spec.config["int_bits"]
    st, wit = a.inputs(4)
    zv = st.get_z_vector(wit.w_ccs)
    assert zv == z.tolist()
    a.ccs.check_relation(st.constraints, zv)  # raises unless satisfied
    assert st.constraints[0] is a.inputs(5)[0].constraints[0]  # A is one object all run long
    assert a.z(WARM).tolist() != z.tolist()


def test_sumcheck_tables_are_fixed_by_seed_and_step_and_below_q():
    spec = specs.load("sumcheck-2p20")
    mk = lambda seed: specs.module("drivers", "sumcheck").Cell(  # noqa: E731
        spec.config, dict(spec.traffic, log_n=6), seed, "cpu")
    a, b = mk(3000000019), mk(3000000019)
    assert torch.equal(a.tables(3), b.tables(3)) and not torch.equal(a.tables(3), a.tables(4))
    q = spec.config["modulus"]
    tabs = a.reference_tables(3)
    assert len(tabs) == sum(spec.config["factors_per_product"]) and len(tabs[0]) == 64
    assert all(0 <= int(v) < q for t in tabs for v in t)
    low = mk(3000000019)
    ctl = specs.module("drivers", "sumcheck").Cell(spec.config, dict(spec.traffic, log_n=6),
                                                   3000000019, "cpu", control=True)
    assert ctl.tables(3, ctl.cfg).shape[-1] == 2 and low.tables(3).shape[-1] == 6
    assert a.coeffs(3) == b.coeffs(3) != a.coeffs(4) and all(0 <= c < q for c in a.coeffs(3))
