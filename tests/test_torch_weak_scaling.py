"""``scripts/torch_weak_scaling_table.py`` at the tiny config, two rows per
data rank: a row per mesh and axis, the model axis's collectives present
only where ``model`` is 2, the data axis's features gathered over the
global batch and no rank-3 float gather on it; the script imports nothing
of the JAX package."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_weak_scaling_table.py")


def _rows(text):
    rows = []
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 8 and cells[0].isdigit():
            rows.append(cells)
    return rows


def test_the_table_by_mesh_and_axis():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    result = subprocess.run([sys.executable, SCRIPT, "2"], capture_output=True, text=True,
                            cwd=REPO, env=env, timeout=600)
    assert result.returncode == 0, result.stderr[-3000:]
    rows = _rows(result.stdout)
    assert [tuple(r[:4]) for r in rows] == [
        ("1", "1", "2", "-"), ("2", "1", "4", "data"), ("1", "2", "2", "data"),
        ("1", "2", "2", "model"), ("2", "2", "4", "data"), ("2", "2", "4", "model")]
    by = {(r[0], r[1], r[3]): r for r in rows}
    count = lambda cell: int(cell.split(",")[0])
    for key in (("1", "2", "model"), ("2", "2", "model")):
        # 7 sharded attentions gather their heads; 7 row-parallel outputs reduce
        assert count(by[key][4]) == 7 and count(by[key][5]) >= 7
    for key in (("2", "1", "data"), ("1", "2", "data"), ("2", "2", "data")):
        assert count(by[key][4]) == 6 and count(by[key][5]) >= 1  # two pair losses, 3 each
        assert by[key][6] == "0"
    # the data axis moves the same payload at (2, 1) and (2, 2): the gradient
    # mean of the sharded leaves is split over the model ranks
    kb = lambda cell: float(cell.split(",")[1])
    assert kb(by[("2", "2", "data")][4]) == kb(by[("2", "1", "data")][4])
    assert kb(by[("2", "2", "data")][5]) < kb(by[("2", "1", "data")][5])
    assert all(float(r[7]) > 0 for r in rows)


def test_the_script_imports_torch_and_the_port_only():
    tree = ast.parse(open(SCRIPT).read())
    names = {n.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for n in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not names & {"jax", "speechclip_tpu", "yaml"}
    assert "speechclip_tpu_torch" in names
