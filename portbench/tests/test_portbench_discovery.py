"""A configuration, a traffic mix and a metric dropped in as new files
(and entries of BENCHMARK.json) under a copy of the benchmark are found
by name, with no file of the harness edited."""
import json
import subprocess
import sys
import textwrap

from .helpers import add_small_config, bench_copy

SCRIPT = textwrap.dedent("""
    import json, sys, time, torch
    from pathlib import Path
    from portbench import harness
    cell = harness.resolve(Path('.'), sys.argv[1])
    harness.run_cell(cell, 2 ** 31 + 9, 0.3, sys.argv[2] == '1',
                     torch.device('cpu'), time.time())
""")


def test_new_files_found_by_name(tmp_path):
    root = bench_copy(tmp_path)
    cfg = add_small_config(root, "poisson2000", 24)
    (root / "portbench/traffic/solve_stream_half.json").write_text(
        json.dumps({"request": "solve", "loop": "closed", "clients": 1,
                    "rhs": {"low": -0.5, "high": 0.5, "where": "device"}}))
    (root / "portbench/metrics/rhs_count.py").write_text(
        "def read(run):\n    return float(run.completed)\n")
    cell = f"{cfg}.half"
    (root / f"portbench/limits/{cell}.json").write_text(
        json.dumps({"forward_error": 1e-3}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name=cell, config=cfg,
                                   traffic="solve_stream_half", chips=1,
                                   why="test"))
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append(dict(
        name="rhs_count.half", unit="count", better="higher",
        source="program_counter", layer="entry", moves="solve_s",
        workloads=[cell]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (root / "portbench").glob("*.py")}
    for trace in ("0", "1"):
        proc = subprocess.run([sys.executable, "-c", SCRIPT, cell, trace],
                              cwd=root, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        want = ({"solve_s", "setup_s"} if trace == "0"
                else {"rhs_count.half"})
        assert set(line["metrics"]) == want
        if trace == "1":
            assert line["metrics"]["rhs_count.half"]["value"] \
                == line["attempted"]
    assert before == {p: p.read_bytes()
                      for p in (root / "portbench").glob("*.py")}


def test_reader_by_full_name_then_stem(tmp_path, monkeypatch):
    from portbench import harness
    monkeypatch.setattr(harness, "HERE", bench_copy(tmp_path) / "portbench")
    (harness.HERE / "metrics/iterations.solve.py").write_text(
        "def read(run):\n    return 42.0\n")
    assert harness.reader("iterations.solve")(None) == 42.0
    assert harness.reader("iterations.other") is not None
