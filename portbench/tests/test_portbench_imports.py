"""Nothing a run loads has the top-level name `jax`, `jaxlib`, `flax` or
`streamchat_tpu` (names compared whole: the port's own name begins with
the JAX package's), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from portbench import run
from portbench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")


def _top_level_imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _, files in os.walk(top):
        if os.sep + "tests" in d[len(BENCH):]:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_forbidden_names_compare_whole():
    assert "streamchat_tpu" in run.FORBIDDEN
    mods = {"streamchat_tpu_torch.models", "jaxtyping", "numpy"}
    assert not {m.split(".")[0] for m in mods} & set(run.FORBIDDEN)


def test_no_source_of_the_harness_imports_jax():
    for path in _sources():
        assert not _top_level_imports(path) & set(run.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = _top_level_imports(path)
        assert not names & (set(run.FORBIDDEN) | {"streamchat_tpu_torch"}), path


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench.tests.conftest import tiny\n"
        "from portbench import run\n"
        "cfg, spec = tiny('qa')\n"
        "out = run.run_cell('longva7b-int8.qa', 3, 0.2, False, 'cpu', config_override=cfg,"
        " spec_override=spec)\n"
        "ref = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps([run.forbidden_modules(), 'streamchat_tpu_torch' in ref]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    bad, port_loaded = __import__("json").loads(res.stdout.strip().splitlines()[-1])
    assert bad == [] and port_loaded


def test_the_reference_alone_loads_no_program_module():
    code = (f"import sys\nsys.path.insert(0, {ROOT!r})\n"
            "import portbench.reference.model, portbench.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'streamchat_tpu', 'streamchat_tpu_torch'}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_prints_no_result():
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "longva7b-int8.stream", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
