"""What the harness and the reference load, and how a run refuses to start.

Modules are compared by their top-level name (the part before the first dot),
whole: the port's name begins with the JAX package's."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "posendf_tpu")


def _python(code: str, cwd: Path = CHECKOUT) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def _tops(out: str) -> set:
    return set(json.loads(out.strip().splitlines()[-1]))


LOADED = "import sys, json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def test_a_run_and_every_file_the_harness_finds_load_no_jax():
    proc = _python(
        "import sys; sys.path.insert(0, '.'); import torch; torch.set_num_threads(2)\n"
        "from benchmark import calibrate, manifest, run\n"
        "bench = manifest.load()\n"
        "for m in bench['per_layer']: manifest.metric_module(m['name'])\n"
        "mix = manifest.traffic('score-131k'); mix.update(batch=8, pool=2, check_poses=8)\n"
        "run.run_cell(bench, 'lrelu-score-131k', 5, 0.01, True, 'cpu', traffic=mix)\n"
        "for w in bench['workloads']: manifest.kind_module(manifest.traffic(w['traffic'])['kind'])\n"
        + LOADED)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = _tops(proc.stdout)
    assert "posendf_torch" in tops and not tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    proc = _python("import sys; sys.path.insert(0, '.')\n"
                   "from benchmark.reference import posendf_ref\n" + LOADED)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert not _tops(proc.stdout) & set(FORBIDDEN + ("posendf_torch",))


def test_without_a_card_a_run_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "lrelu-score-131k",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=CHECKOUT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 3 and proc.stdout == ""


def test_with_only_the_benchmarks_files_a_run_fails(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import manifest, run\n"
        "bench = manifest.load(); mix = manifest.traffic('score-131k')\n"
        "mix.update(batch=8, pool=2, check_poses=8)\n"
        "print(run.run_cell(bench, 'lrelu-score-131k', 5, 0.01, False, 'cpu', traffic=mix))",
        cwd=tmp_path)
    assert proc.returncode != 0 and "posendf_torch" in proc.stderr and proc.stdout == ""
