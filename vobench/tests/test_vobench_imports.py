"""Nothing the harness runs imports JAX or the JAX package: the top-level
name of each module is compared whole, so `rso_torch` passes and `rso`
does not."""
import ast
import json
import os
import shutil
import subprocess
import sys

import _cells
from vobench import run

BENCH = _cells.ROOT / "vobench"


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"rso_torch", "rso_torch.engine", "rso", "rso.engine", "jax",
            "jaxlib.xla_client", "flax.linen", "jaxtyping", "rsox", "numpy"}
    assert run.forbidden_modules(mods) == ["flax.linen", "jax",
                                           "jaxlib.xla_client", "rso",
                                           "rso.engine"]
    assert run.forbidden_modules({"rso_torch", "rso_torch.ba.ba"}) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_harness_imports_jax_rso_or_the_root_bench():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "rso", "bench",
                           "chip_smoke"}, path


def test_the_reference_and_yardstick_import_nothing_of_the_program():
    for name in ("refvo.py", "stats.py", "roofline.py", "gen.py", "judge.py",
                 "trace.py"):
        tops = {m.split(".")[0] for m in _imports(BENCH / name)}
        assert "rso_torch" not in tops, name


def _run(cwd, *extra):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "vobench/run.py", "--workload", "kitti.live", "--seed",
         "2147483649", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_without_a_card_it_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    p = _run(_cells.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_alone_with_its_files_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(_cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_every_named_file_exists():
    bench = json.loads((_cells.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = run.load_cell(bench, w["name"])
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
        assert os.path.exists(c["ini"])
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
